"""Cross-silo FedAvg as ``torch.distributed`` collectives, on 4 ranks.

``repro_torch.distributed.fedavg_allreduce`` runs on four ``gloo`` ranks
of the CPU (``sharded_ranks``), each holding its block of silos:

  * the reference's closed-form cases (``tests/test_fedavg_mesh.py``) on
    a ("data", "model") = (2, 2) mesh, reduced over "data" (the "model"
    ranks hold replicas): the uniform mean 1.5 and the weighted 2.25;
  * seeded numpy silos (8, float32) against the JAX function run on 8
    forced host devices in a subprocess, over "data" and hierarchically
    over ("pod", "data"), within 1e-6;
  * ``weighted_psum_sum`` over the default group: the weighted sums and
    the weight total, the same bits on every rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import sharded_ranks as sr  # noqa: E402
from repro.utils.xla_env import forced_host_device_env  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_WORKER = r"""
import sys
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.fedavg_mesh import fedavg_allreduce

with np.load(sys.argv[2]) as z:
    silos = {"w": z["w"], "b": z["b"]}
    weights = z["weights"]
out = {}
for name, shape, axes in (("data", (4, 2), ("data", "model")),
                          ("pod_data", (2, 4), ("pod", "data"))):
    mesh = jax.make_mesh(shape, axes)
    client = ("data",) if name == "data" else ("pod", "data")
    put = lambda x: jax.device_put(
        x, NamedSharding(mesh, P(client, *([None] * (x.ndim - 1)))))
    res = fedavg_allreduce({k: put(v) for k, v in silos.items()},
                           put(weights), mesh, client_axes=client)
    out.update({f"{name}:{k}": np.asarray(v) for k, v in res.items()})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(the port's 4 ranks' results, the JAX results, the inputs)."""
    tmp = tmp_path_factory.mktemp("fedavg")
    rng = np.random.default_rng(0)
    silos = {"w": rng.normal(size=(8, 3, 5)).astype(np.float32),
             "b": rng.normal(size=(8, 5)).astype(np.float32)}
    weights = rng.uniform(0.5, 4.0, size=8).astype(np.float32)
    np.savez(tmp / "in.npz", weights=weights, **silos)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_WORKER, str(tmp / "jax.npz"),
         str(tmp / "in.npz")], env=forced_host_device_env(8, REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = sr.run_ranks(sr.fedavg_cases, 4, tmp, silos, weights)
    finally:
        _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    with np.load(tmp / "jax.npz") as z:
        ref = {k: z[k] for k in z.files}
    return ranks, ref, (silos, weights)


@pytest.mark.parametrize("case,want", [("uniform", 1.5), ("weighted", 2.25)])
def test_closed_form_means(meshes, case, want):
    ranks, _, _ = meshes
    for r in ranks:
        out = r[case]
        assert out["w"].shape == (3,) and out["b"].shape == ()
        np.testing.assert_allclose(out["w"], want)
        np.testing.assert_allclose(out["b"], want)


@pytest.mark.parametrize("case", ["data", "pod_data"])
def test_matches_jax_fedavg_allreduce(meshes, case):
    ranks, ref, (silos, weights) = meshes
    mean = {k: np.tensordot(weights.astype(np.float64), v, axes=1)
            / weights.sum(dtype=np.float64) for k, v in silos.items()}
    for r in ranks:
        for k in silos:
            np.testing.assert_allclose(r[case][k], ref[f"{case}:{k}"],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(r[case][k], mean[k], rtol=0,
                                       atol=1e-6)
    for r in ranks[1:]:
        for k in silos:
            assert np.array_equal(r[case][k], ranks[0][case][k])


def test_weighted_psum_sum_same_bits_on_every_rank(meshes):
    ranks, _, (silos, weights) = meshes
    for r in ranks:
        np.testing.assert_allclose(r["psum"]["total"], weights.sum(),
                                   rtol=1e-6)
        for k, v in silos.items():
            np.testing.assert_allclose(
                r["psum"][k], np.tensordot(weights, v, axes=1), rtol=0,
                atol=1e-5)
            assert np.array_equal(r["psum"][k], ranks[0]["psum"][k])
