"""Micro-benchmark: batched dynamic gathers vs one-hot matmuls.

Compares the two ways the coupled solver can fetch contact-candidate
triangle corners: the grasp-lift energy graph re-executes per-env
dynamic-index gathers inside every energy/hvp evaluation (~400 per
env-step); a (R, V) one-hot matrix applied as a matmul does the same fetch
as a batched GEMM.

Shapes mirror the grasp-lift world: V=150 union gel verts, R=1584 gathered
triangle-corner rows, plus the tiny cube table (Va=8).

Usage: python scripts/benchmarking/microbench_gather.py [--envs 16]
"""

from __future__ import annotations

import argparse
import json
import sys as _sys
import time
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[2]))

import numpy as np

import jax
import jax.numpy as jnp


def timeit(fn, *args, iters=200) -> float:
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e6  # us


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=16)
    args = ap.parse_args()
    N = args.envs
    V, R = 150, 1584
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (N, V, 3), jnp.float32)
    idx = jax.random.randint(key, (N, R), 0, V)
    idx_static = jax.random.randint(key, (R,), 0, V)
    onehot = jax.nn.one_hot(idx, V, dtype=jnp.float32)  # (N, R, V)
    onehot_s = jax.nn.one_hot(idx_static, V, dtype=jnp.float32)  # (R, V)

    dyn = jax.jit(lambda x, i: jnp.take_along_axis(x, i[..., None], axis=1))
    sta = jax.jit(lambda x: x[:, idx_static])
    oh = jax.jit(lambda x, m: jnp.einsum("nrv,nvc->nrc", m, x))
    oh_s = jax.jit(lambda x: jnp.einsum("rv,nvc->nrc", onehot_s, x))
    build = jax.jit(lambda i: jax.nn.one_hot(i, V, dtype=jnp.float32))

    # chains of 8 dependent applications approximate the sequential
    # energy/hvp evaluations inside one Newton iteration (no overlap)
    def chain_dyn(x):
        acc = x
        for _ in range(8):
            g = jnp.take_along_axis(acc, idx[..., None], axis=1)
            acc = acc + 1e-6 * jnp.tanh(g[:, :V])
        return acc

    def chain_oh(x):
        acc = x
        for _ in range(8):
            g = jnp.einsum("nrv,nvc->nrc", onehot, acc)
            acc = acc + 1e-6 * jnp.tanh(g[:, :V])
        return acc

    rows = [
        ("index_gather", timeit(dyn, x, idx)),
        ("static_idx_gather", timeit(sta, x)),
        ("onehot_matmul", timeit(oh, x, onehot)),
        ("onehot_static_matmul", timeit(oh_s, x)),
        ("onehot_build", timeit(build, idx)),
        ("chain8_dynamic", timeit(jax.jit(chain_dyn), x)),
        ("chain8_onehot", timeit(jax.jit(chain_oh), x)),
    ]
    for name, us in rows:
        print(json.dumps({"op": name, "envs": N, "us": round(us, 2),
                          "ns_per_row": round(us * 1e3 / (N * R), 3)}), flush=True)


if __name__ == "__main__":
    main()
