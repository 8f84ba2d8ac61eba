"""Mixture serving: Eq. (2) as an inference service.

ServableArtifact (artifact.py) is the shipped plane, ClusterPlaneServer
(server.py) answers request batches off the resident plane, and
experiments/export.py makes artifacts from finished runs. The JAX
package's ``ServeConfig`` and ``launch/serve.py`` CLI wait for the LM
model zoo and the launch layer.
"""
from repro_torch.serve.artifact import (  # noqa: F401
    ServableArtifact,
    load_servable,
    save_servable,
)
from repro_torch.serve.server import ClusterPlaneServer  # noqa: F401
