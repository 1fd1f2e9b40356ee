"""Scientific-field substrate of the port: the cavitation QoI generator and
the mini Euler solver."""
from .cavitation import PAPER_TIMES, QOIS, CloudConfig, cavitation_fields  # noqa: F401
from .euler3d import EulerConfig, init_bubble_cloud, primitives, run, step  # noqa: F401
