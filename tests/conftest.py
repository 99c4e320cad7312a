"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic is
exercised without GPUs (SURVEY.md §4: XLA host-count simulation).
Must run before the first jax import.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# force CPU explicitly (a GPU plugin would otherwise take precedence) so
# tests run on the 8-device virtual CPU mesh
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from parallel_gcn.data.graph import build_graph, random_graph  # noqa: E402


@pytest.fixture(scope="session")
def small_graph():
    """Synthetic 50-node graph: host CSR + padded device Graph (with dense Â)."""
    csr, _ = random_graph(50, avg_degree=6, seed=0)
    graph = build_graph(csr, dense=True)
    return csr, graph


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def has_dataset(name: str) -> bool:
    try:
        from parallel_gcn.data.parser import find_data_dir

        find_data_dir(name)
        return True
    except FileNotFoundError:
        return False


requires_cora = pytest.mark.skipif(
    not has_dataset("cora"), reason="cora dataset not available"
)


@pytest.fixture(scope="session")
def cora_like_dir(tmp_path_factory):
    """A small graph written in the reference's dataset format under the
    name ``cora`` (``cora.graph`` neighbour lists, ``cora.svmlight`` labels +
    sparse features, ``cora.split`` 1/2/3 per node), for driving the CLI
    through ``data_dir=``. Not cora's published statistics."""
    rng = np.random.default_rng(7)
    n, f, c = 120, 30, 3
    labels = rng.integers(0, c, n)
    nbrs = [set() for _ in range(n)]
    for i in range(n):
        same = np.flatnonzero(labels == labels[i])
        for j in rng.choice(same, 3):
            if j != i:
                nbrs[i].add(int(j))
                nbrs[int(j)].add(i)
    d = tmp_path_factory.mktemp("cora_like")
    with open(d / "cora.graph", "w") as fh:
        for s in nbrs:
            fh.write(" ".join(str(j) for j in sorted(s)) + "\n")
    with open(d / "cora.svmlight", "w") as fh:
        for i in range(n):
            cols = np.sort(rng.choice(f, 5, replace=False))
            cols[0] = labels[i]  # a weakly label-correlated feature
            cols = np.unique(cols)
            feats = " ".join(f"{k}:{rng.random() + 0.5:.4f}" for k in cols)
            fh.write(f"{labels[i]} {feats}\n")
    split = rng.choice([1, 2, 3], size=n, p=[0.5, 0.25, 0.25])
    np.savetxt(d / "cora.split", split, fmt="%d")
    return str(d)
