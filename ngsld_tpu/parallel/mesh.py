"""Device mesh construction for the LD sweep.

The reference's only parallelism is a pthread pool over anchor sites
(ngsLD.cpp:154-186). The device replacement is a 2-D mesh:

  * 'pairs' — data parallelism over the flat banded pair plan (the
    embarrassingly-parallel axis; replaces the thread pool).
  * 'ind'   — model-parallel split of the individual axis: the EM's
    per-individual reductions become psum collectives. Useful when
    cohorts are large (individuals in the thousands) or when pair shards
    alone cannot fill the mesh.

Multi-host: initialize with jax.distributed (see init_distributed) and build
the same mesh over all global devices; each host feeds its own pair blocks.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_pairs_shards: int = None, n_ind_shards: int = 1,
              devices=None) -> Mesh:
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if n_pairs_shards is None:
        n_pairs_shards = n // n_ind_shards
    assert n_pairs_shards * n_ind_shards == n, \
        f"mesh {n_pairs_shards}x{n_ind_shards} != {n} devices"
    arr = np.array(devices).reshape(n_pairs_shards, n_ind_shards)
    return Mesh(arr, ("pairs", "ind"))


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None) -> None:
    """Multi-host bring-up (replaces: nothing — the reference is single-node).

    Call once per host before building the mesh. Nothing in the
    environment describes the cluster, so pass coordinator ("host:port"),
    num_processes and process_id explicitly.
    """
    kw = {}
    if coordinator is not None:
        kw = dict(coordinator_address=coordinator,
                  num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kw)
