"""The serving layer's host side: the model registry and the traffic ring.

Ports of the JAX package's ``socceraction_tpu/serve/registry.py``
(:class:`ModelRegistry`: versioned checkpoints, warm device residency,
atomic activation and rollback, the candidate lifecycle) and
``serve/capture.py`` (:class:`TrafficCapture`). The in-process rating
service, its batcher and sessions come later (ROADMAP A3). Importing this
package needs neither pandas nor msgpack.
"""

from .capture import TrafficCapture
from .registry import ModelRegistry

__all__ = ['ModelRegistry', 'TrafficCapture']
