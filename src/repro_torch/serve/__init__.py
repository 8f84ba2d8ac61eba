"""Mixture serving: Eq. (2) as an inference service.

ServableArtifact (artifact.py) is the shipped plane, ClusterPlaneServer
(server.py) answers request batches off the resident plane (classifier
``predict``, LM ``generate``), ServeConfig (config.py) is the one
configuration object of a serve run, and experiments/export.py makes
artifacts from finished runs; ``launch/serve.py`` is the CLI.
"""
from repro_torch.serve.artifact import (  # noqa: F401
    ServableArtifact,
    load_servable,
    save_servable,
)
from repro_torch.serve.config import SERVE_CODECS, ServeConfig  # noqa: F401
from repro_torch.serve.server import ClusterPlaneServer  # noqa: F401
