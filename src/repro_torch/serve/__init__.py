"""serve subsystem of the port: compressed-field region serving and LLM
decode (port of ``repro.serve``).

Two independent stacks share this package:

* **field serving**: :class:`FieldRegionServer` (tiered decode cache +
  single-flight scheduler, ``serve.region`` / ``serve.cache`` /
  ``serve.scheduler``) and its HTTP front (:class:`RegionHTTPServer` +
  :class:`Client`, ``serve.http`` — stdlib ``http.server``, started via
  ``python -m repro_torch.launch.compress serve``).  Cold chunks are
  decoded on the torch ``device`` the dataset is opened with (the card by
  default), by the scheme's decode kernel;
* **LLM decode** (``serve.step``): prefill and decode steps on one torch
  device — imported explicitly, never from here, so serving compressed
  fields stays free of the model stack.
"""
from .cache import RegionCache  # noqa: F401
from .http import Client, RegionHTTPServer  # noqa: F401
from .region import FieldRegionServer, LatencyHistogram  # noqa: F401
from .scheduler import ChunkScheduler, SingleFlight  # noqa: F401

__all__ = ["FieldRegionServer", "RegionHTTPServer", "Client", "RegionCache",
           "ChunkScheduler", "SingleFlight", "LatencyHistogram"]
