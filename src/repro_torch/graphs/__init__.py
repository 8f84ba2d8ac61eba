"""Client graphs (numpy): the topologies, their dynamic schedules, the
mixing matrices and the edge colouring of the permute wiring; see the
module docstrings."""
from repro_torch.graphs.coloring import (  # noqa: F401
    greedy_edge_coloring,
    permute_schedule,
    schedule_stats,
    validate_coloring,
)
from repro_torch.graphs.mixing import (  # noqa: F401
    consensus_rate_p,
    expected_fedspd_consensus_rate,
    metropolis_weights,
    spectral_gap,
    uniform_neighbor_weights,
)
from repro_torch.graphs.topology import (  # noqa: F401
    Graph,
    GraphSchedule,
    barabasi_albert,
    complete,
    drop_edges,
    dropout_schedule,
    erdos_renyi,
    make_graph,
    pod_aware,
    random_geometric,
    rewire,
    rewire_schedule,
    ring,
    stack_schedule,
    symmetric_mask_drop,
    union_graph,
)
