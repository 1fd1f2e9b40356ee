"""Scientific-field substrate of the port: the cavitation QoI generator."""
from .cavitation import PAPER_TIMES, QOIS, CloudConfig, cavitation_fields  # noqa: F401
