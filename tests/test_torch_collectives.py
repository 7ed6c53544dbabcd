"""The port's tensor-parallel collectives on CPU ranks against the JAX package.

Ranks are threads of one process (``make_mesh(..., devices=["cpu"] * n)``),
the JAX side an 8-device host mesh (tests/conftest.py). Tolerances:

  * ``fuse_allreduce_rmsnorm_sharded`` (the model's epilogue) against JAX's
    on tests/test_collectives.py's grid: ``out_res`` within one bf16 step,
    ``out`` within two. Both sum the same bf16 partials in float32, JAX's
    ``psum`` in its own order, the port in absolute rank order, so the
    float32 sums may round to neighbouring bf16 values; ``out`` carries that
    step through the norm and its own bf16 rounding;
  * ``fuse_allreduce_rmsnorm_pallas`` (the TPU kernel's epilogue) against
    JAX's ``fuse_allreduce_rmsnorm_ref`` at tests/test_collective_kernels.py's
    cases and bar (max abs error 0.05), ``skew`` included;
  * every rank's outputs bitwise equal to every other rank's and to the
    kernel's plain version.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.parallel import fuse_allreduce_rmsnorm_ref as jax_ref
from hpc_ops_tpu.parallel import fuse_allreduce_rmsnorm_sharded as jax_sharded
from hpc_ops_tpu.parallel import make_mesh as jax_make_mesh
from hpc_ops_tpu_torch import parallel as P
from hpc_ops_tpu_torch.parallel.collective_kernels import (
    _allreduce_rmsnorm_ref,
    _row_mean_square,
    allreduce_rmsnorm,
)
from hpc_ops_tpu_torch.parallel.mesh import make_hybrid_mesh, run_ranks
from hpc_ops_tpu_torch.utils.testing import max_bf16_ulp_err

torch.set_num_threads(1)


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def jbf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def cpu_mesh(tp, dp=1):
    return P.make_mesh(tp=tp, dp=dp, devices=["cpu"] * (tp * dp))


@pytest.mark.parametrize("mode", ["two_shot", "one_shot"])
@pytest.mark.parametrize("n,h", [(8, 256), (64, 1024)])
@pytest.mark.parametrize("ws", [4, 8])
def test_fuse_allreduce_rmsnorm_sharded_matches_jax(mode, n, h, ws):
    rng = np.random.RandomState(10001)
    x_parts = bf16(rng.randn(ws, n, h))
    residual = bf16(rng.randn(n, h))
    weight = bf16(rng.randn(h))
    out, out_res = P.fuse_allreduce_rmsnorm_sharded(cpu_mesh(ws), x_parts, residual, weight, 1e-6,
                                                    mode=mode)
    jmesh = jax_make_mesh(tp=ws, devices=jax.devices("cpu"))
    want, want_res = jax_sharded(jmesh, jbf16(x_parts), jbf16(residual), jbf16(weight), 1e-6, mode=mode)
    assert out.dtype == out_res.dtype == torch.bfloat16 and tuple(out.shape) == (n, h)
    assert max_bf16_ulp_err(out_res.float(), np.asarray(want_res, np.float32)) <= 1
    assert max_bf16_ulp_err(out.float(), np.asarray(want, np.float32)) <= 2
    # and the port's own oracle
    ref, ref_res = P.fuse_allreduce_rmsnorm_ref(x_parts, residual, weight, 1e-6)
    assert max_bf16_ulp_err(out_res.float(), ref_res.float()) <= 1
    assert max_bf16_ulp_err(out.float(), ref.float()) <= 2


def run_pallas(ws, n, h, mode, skew, seed=0):
    """Every rank's (out, out_res) of fuse_allreduce_rmsnorm_pallas on CPU
    ranks, with tests/test_collective_kernels.py's inputs."""
    rng = np.random.RandomState(seed)
    xp = bf16(rng.randn(ws, n, h))
    res = bf16(rng.randn(n, h))
    w = bf16(rng.rand(h))
    outs = run_ranks(cpu_mesh(ws), lambda g, _: P.fuse_allreduce_rmsnorm_pallas(
        xp[g.rank], res, w, ws=ws, axis_name=g, mode=mode, interpret=True, skew=skew))[0]
    return xp, res, w, outs


@pytest.mark.parametrize("ws,n,h,mode,skew", [
    (4, 32, 256, "one_shot", 0), (4, 32, 256, "two_shot", 0), (8, 64, 256, "two_shot", 0),
    (4, 32, 256, "one_shot", 4000), (4, 32, 256, "two_shot", 4000),
])
def test_pallas_plain_path_matches_jax_ref_and_replicates(ws, n, h, mode, skew):
    xp, res, w, outs = run_pallas(ws, n, h, mode, skew)
    want, want_res = jax_ref(jbf16(xp), jbf16(res), jbf16(w))
    out, out_res = outs[0]
    assert float(np.abs(out.float().numpy() - np.asarray(want, np.float32)).max()) < 0.05
    assert float(np.abs(out_res.float().numpy() - np.asarray(want_res, np.float32)).max()) < 0.05
    plain = _allreduce_rmsnorm_ref(list(xp), res, w, 1e-6, mode, bf16_norm=False)
    for r, (o, o_res) in enumerate(outs):
        assert torch.equal(o, plain[0]) and torch.equal(o_res, plain[1]), f"rank {r}"
        assert o is not out or r == 0  # each rank holds its own tensors


@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
def test_every_rank_and_dp_group_gets_bitwise_equal_outputs(mode):
    """Two tp groups of 4 (dp 2) reduce different partials at once, with the
    model's epilogue; within a group every rank's outputs are bit-equal and
    equal the plain version's."""
    rng = np.random.RandomState(3)
    xp = bf16(rng.randn(2, 4, 32, 264))  # [dp, tp, N, H]: H not a multiple of the 1024-column sweep
    res = bf16(rng.randn(2, 32, 264))
    w = torch.from_numpy(rng.rand(264).astype(np.float32))
    outs = run_ranks(cpu_mesh(4, dp=2), lambda g, d: P.fuse_allreduce_rmsnorm(
        xp[d, g.rank], res[d], w, 1e-5, g, mode=mode))
    for d in range(2):
        want = _allreduce_rmsnorm_ref(list(xp[d]), res[d], w, 1e-5, mode, bf16_norm=True)
        for o, o_res in outs[d]:
            assert torch.equal(o, want[0]) and torch.equal(o_res, want[1])
    assert not torch.equal(outs[0][0][1], outs[1][0][1])


def test_two_shot_refuses_n_not_divisible_by_8_ws():
    with pytest.raises(ValueError, match="divisible by 8"):
        run_pallas(4, 36, 256, "two_shot", 0)
    x = [torch.zeros((25, 64), dtype=torch.bfloat16)] * 2
    with pytest.raises(ValueError, match="divisible by axis_size"):  # the kernel's own bound
        allreduce_rmsnorm(x, x, [torch.ones(64)] * 2, x, x, 1e-6, "two_shot", False)
    with pytest.raises(ValueError, match="unknown mode"):
        allreduce_rmsnorm(x, x, [torch.ones(64)] * 2, x, x, 1e-6, "three_shot", False)


def test_a_rank_that_raises_fails_the_call_and_the_mesh_runs_again():
    mesh = cpu_mesh(4)
    x = torch.randn((16, 64)).to(torch.bfloat16)
    w = torch.ones(64)

    def rank(g, _):
        if g.rank == 2:
            raise RuntimeError("rank 2 failed")
        return P.fuse_allreduce_rmsnorm(x, x, w, 1e-6, g, mode="one_shot")

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 2 failed"):
        run_ranks(mesh, rank)
    assert time.perf_counter() - t0 < 10  # the others were released, not timed out
    outs = run_ranks(mesh, lambda g, _: P.fuse_allreduce_rmsnorm(x, x, w, 1e-6, g, mode="one_shot"))
    assert all(torch.equal(o[0], outs[0][0][0]) for o in outs[0])
    # a failure in the collective itself (the ranks disagree on the mode)
    with pytest.raises(ValueError, match="disagree"):
        run_ranks(mesh, lambda g, _: P.fuse_allreduce_rmsnorm(
            x, x, w, 1e-6, g, mode="one_shot" if g.rank else "two_shot"))


def test_row_mean_square_follows_the_kernel_order_and_is_accurate():
    """The plain version's sum of squares in the kernel's order (ragged chunk
    sweeps included) is within float32 rounding of the float64 mean."""
    rng = np.random.RandomState(4)
    for h in (8, 256, 264, 4096, 7168):
        r = torch.from_numpy(rng.randn(3, h).astype(np.float32))
        want = (r.double() ** 2).mean(dim=-1, keepdim=True)
        got = _row_mean_square(r)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1)
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=0)


def test_meshes_match_jax_and_refuse_what_is_not_ported():
    mesh = P.make_mesh(tp=4, dp=2, devices=["cpu"] * 8)
    jmesh = jax_make_mesh(tp=4, dp=2, devices=jax.devices("cpu"))
    assert mesh.axis_names == jmesh.axis_names and dict(mesh.shape) == dict(jmesh.shape)
    assert mesh.devices.shape == jmesh.devices.shape
    assert P.tp_sharding(mesh, None, "tp").spec == (None, "tp")
    with pytest.raises(ValueError, match="need 8 devices"):
        P.make_mesh(tp=4, dp=2, devices=["cpu"] * 4)
    # distinct CUDA devices this process does not see (the layout rules:
    # tests/test_torch_hybrid_mesh.py)
    with pytest.raises(ValueError, match="not visible"):
        P.make_mesh(tp=2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    hmesh = make_hybrid_mesh(dcn_dp=2, tp=4, devices=["cpu"] * 8)
    assert hmesh.axis_names == ("ddp", "dp", "tp") and hmesh.grid.shape == (2, 4)


@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
def test_plain_version_equals_a_numpy_float32_walk_of_the_kernel(mode):
    """The plain version against numpy's IEEE float32 steps in the kernel's
    order, bit for bit: every step is correctly rounded, so the card (the
    kernel and torch's CUDA ops) and the CPU agree."""
    rng = np.random.RandomState(5)
    ws, n, h = 4, 64, 5120
    xs = [bf16(rng.randn(n, h) * 0.5) for _ in range(ws)]
    res, w = bf16(rng.randn(n, h)), torch.from_numpy(rng.rand(h).astype(np.float32) + 0.5)
    f32 = np.float32
    x = [t.float().numpy() for t in xs]
    if mode == "one_shot":
        acc = np.zeros((n, h), f32)
        for a in x:
            acc = acc + a
    else:
        c = n // ws
        acc = np.concatenate([sum((x[s][r * c:(r + 1) * c] for s in range(ws) if s != r),
                                  start=x[r][r * c:(r + 1) * c]) for r in range(ws)])
    r_ = acc + res.float().numpy()
    p = np.zeros((n, 128), f32)
    sq = np.pad(r_ * r_, ((0, 0), (0, 1024 * 5 - h))).reshape(n, 5, 128, 8)
    for k in range(5):
        for j in range(8):
            p = p + sq[:, k, :, j]
    v = p.reshape(n, 4, 32)
    while v.shape[-1] > 1:
        v = v[..., : v.shape[-1] // 2] + v[..., v.shape[-1] // 2:]
    v = v[..., 0]
    rms = f32(1) / np.sqrt(((v[:, 0] + v[:, 2]) + (v[:, 1] + v[:, 3])) / f32(h) + f32(1e-5))
    want = torch.from_numpy((r_ * rms[:, None]) * w.numpy()).to(torch.bfloat16)
    out, out_res = _allreduce_rmsnorm_ref(xs, res, w, 1e-5, mode, bf16_norm=False)
    assert torch.equal(out, want) and torch.equal(out_res, torch.from_numpy(r_).to(torch.bfloat16))
