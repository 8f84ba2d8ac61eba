"""The paper's own experimental scale: small classifier heads over mixture
data (paper Tables 2–7 analogues). A copy of the JAX package's
``PaperExpConfig`` with the same fields and defaults; ``mlp`` at these
defaults packs to X = 17,226 parameters per model."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExpConfig:
    n_clients: int = 20
    n_clusters: int = 2
    model: str = "mlp"  # mlp | conv
    dim: int = 64
    n_classes: int = 10
    n_per_client: int = 256
    rounds: int = 60
    tau: int = 5  # local epochs per round (paper default 5)
    tau_final: int = 10
    lr0: float = 5e-2
    lr_decay: float = 0.98
    batch: int = 32
    graph_kind: str = "er"
    avg_degree: float = 5.0
    seed: int = 0
    mode: str = "rotate"  # data construction


DEFAULT = PaperExpConfig()
