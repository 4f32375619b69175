"""hp_opt NL-OCD with one agent per rank: 3 agents over a (1, 3) gloo mesh,
where the refined-plane write-back into the replicated pair tensor crosses
every rank boundary, against the JAX package's sharded step on a (1, 3)
mesh of virtual devices. x_pred and lambdas within 2e-3, the JAX package's
own hp_opt sharded-vs-single tolerance (``tests/test_sharding.py:166-169``);
the harness is ``tests/test_torch_sharding.py``'s.
"""

import numpy as np
import torch

from test_torch_sharding import close, join, spawn
from test_torch_sharding_ocd import (
    F32, jax_nl_cfg, jax_sharded, nl_cfg, sharded_ocd, two_fleets,
)

torch.set_num_threads(2)


def hp_opt_rank(rank, world, rdv, start):
    mesh = join(rank, world, rdv, (1, 3))
    return sharded_ocd(mesh, nl_cfg(n_agents=3, max_it_ocd=10,
                                    coupling="hp_opt"), start, F32)


def test_hp_opt_one_agent_per_rank_matches_jax(tmp_path):
    """hp_opt, 3 agents over a (1, 3) mesh: the refined-plane write-back
    crosses every rank boundary."""
    cfg = jax_nl_cfg(n_agents=3, max_it_ocd=10, coupling="hp_opt")
    start, jst, jm = jax_sharded(cfg, two_fleets(cfg, 0.2)[:1], (1, 3))
    ranks = spawn(hp_opt_rank, 3, tmp_path, start)
    for st, m in ranks:
        close(st["x_pred"], jst["x_pred"], 2e-3)
        close(st["lambdas"], jst["lambdas"], 2e-3)
        np.testing.assert_array_equal(m["feasible"], jm["feasible"])
