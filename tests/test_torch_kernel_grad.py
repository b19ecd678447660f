"""Gradients through flash attention and RMSNorm, every route.

Each wrapper is a ``torch.autograd.Function`` whose forward and backward
the device picks: on the card the CUDA kernels (``csrc/rmsnorm.cu``'s
backward; ``csrc/flash_attention_bwd_wgmma.cu`` for bfloat16 at D 64, 112
and 128, ``csrc/flash_attention_bwd.cu`` otherwise), on the CPU the plain
versions ``ref.rmsnorm_bwd`` and ``ref.attention_bwd``.  The JAX package trains
through its plain jnp versions and has no backward kernel, so the plain
backwards are held against ``jax.vjp`` of the JAX plain versions (float32,
1e-5) over every mask case the forwards take, rows that see no key
included; the plain route (``impl="ref"``, differentiated by autograd)
gives the same gradients as ``jax.grad``.  On the card the kernels'
gradients equal the plain route's.  The tensor-core backward rounds P and
dS to bfloat16 before the products that take them; a plain emulation of
that arithmetic holds its limit (:func:`tensor_core_bwd_limit`, the one
``chip_smoke.py`` holds the kernel to) on the CPU, where the limit also
catches the two faults ``chip_smoke.py`` plants in the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as r_attn
from repro.kernels.rmsnorm import ref as r_rms
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.kernels.rmsnorm import ref as rms_ref

GRAD_TOL = 1e-5
# the tensor-core backward's limit: a max|plain| + r |plain| + ra plain(|.|)
# (chip_smoke.py's BWD_TC_LIMIT, derived there)
BWD_TC_LIMIT = (1e-5, 2.0 ** -7, 2.0 ** -7)


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    q = rng.standard_normal((2, 4, 9, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 11, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 11, 32)).astype(np.float32)
    g = rng.standard_normal((2, 4, 9, 32)).astype(np.float32)
    return x, w, q, k, v, g


def _close(got, want, tol=GRAD_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_plain_rmsnorm_route_gives_the_reference_gradients(impl):
    x, w, *_ = _inputs()
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = rms.rmsnorm(xt, wt, impl=impl)
    (out * out).sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(r_rms.rmsnorm(a, b) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(xt.grad.numpy(), gx)
    _close(wt.grad.numpy(), gw)


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 4)])
def test_plain_attention_route_gives_the_reference_gradients(impl, causal,
                                                             window):
    _, _, q, k, v, g = _inputs(1)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, window=window, impl=impl)
    (out * torch.tensor(g)).sum().backward()

    def loss(a, b, c):
        return jnp.sum(r_attn.attention(a, b, c, causal=causal,
                                        window=window) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip(ts, want):
        _close(t.grad.numpy(), w)


@pytest.mark.parametrize("shape,eps", [((3, 5, 64), 1e-6), ((7, 37), 1e-5),
                                       ((2, 1, 4, 128), 1e-6)])
def test_rmsnorm_bwd_matches_jax_vjp(shape, eps):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: r_rms.rmsnorm(a, b, eps=eps),
                     jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = vjp(jnp.asarray(dy))
    got_x, got_w = rms_ref.rmsnorm_bwd(torch.tensor(x), torch.tensor(w),
                                       torch.tensor(dy), eps=eps)
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)


# (b, hq, hkv, sq, skv, d, causal, window): every mask case of the forward
ATTN_CASES = [
    (2, 4, 2, 9, 9, 32, True, None),       # causal, group 2
    (1, 4, 4, 9, 9, 16, False, None),      # not causal, group 1
    (1, 8, 2, 20, 20, 16, True, 5),        # causal window, group 4
    (1, 4, 2, 12, 30, 16, False, 7),       # window, not causal, Sq < Skv
    (2, 4, 2, 7, 19, 32, True, None),      # Sq < Skv, end-aligned
    (1, 6, 2, 13, 5, 16, True, None),      # Sq > Skv: 8 rows see no key
    (1, 4, 1, 11, 4, 16, True, 2),         # Sq > Skv with a window
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_bwd_matches_jax_vjp(case):
    b, hq, hkv, sq, skv, d, causal, window = case
    rng = np.random.default_rng(6)
    q, do = (rng.standard_normal((b, hq, sq, d)).astype(np.float32)
             for _ in "qg")
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
            for _ in "kv")
    out, vjp = jax.vjp(lambda a, c, e: r_attn.attention(
        a, c, e, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    o = attn_ref.attention(tq, tk, tv, causal=causal, window=window)
    _close(o.numpy(), out)
    got = attn_ref.attention_bwd(tq, tk, tv, o, torch.tensor(do),
                                 causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_rows_that_see_no_key_give_dv_and_no_dq():
    """Sq > Skv, causal: the first Sq - Skv rows attend uniformly to every
    key in the forward, so their do reaches dv as do / Skv, while dS is
    zeroed under the mask and their dq is 0."""
    rng = np.random.default_rng(7)
    q, do = (torch.tensor(rng.standard_normal((1, 2, 6, 16)),
                          dtype=torch.float32) for _ in "qg")
    k, v = (torch.tensor(rng.standard_normal((1, 2, 2, 16)),
                         dtype=torch.float32) for _ in "kv")
    do[:, :, 4:] = 0                        # only the keyless rows move
    o = attn_ref.attention(q, k, v)
    dq, dk, dv = attn_ref.attention_bwd(q, k, v, o, do)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, do[:, :, :4].sum(2, keepdim=True)
                               .expand(-1, -1, 2, -1) / 2)


def test_cpu_function_runs_the_plain_backwards():
    """On CPU tensors each wrapper's Function calls the plain backward, at
    the strides autograd hands it (a heads view, an expanded gradient)."""
    rng = np.random.default_rng(8)
    y = torch.tensor(rng.standard_normal((2, 7, 3 * 16)), dtype=torch.float32)
    xv = y.view(2, 7, 3, 16).transpose(1, 2).requires_grad_()
    w = torch.tensor(rng.standard_normal(16), dtype=torch.float32,
                     requires_grad=True)
    rms.rmsnorm(xv, w).sum().backward()     # dy expanded, stride 0
    want = rms_ref.rmsnorm_bwd(xv.detach(), w.detach(),
                               torch.ones(xv.shape))
    assert torch.equal(xv.grad, want[0]) and torch.equal(w.grad, want[1])
    _, _, q, k, v, g = _inputs(2)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, window=3)
    out.backward(torch.tensor(g))
    want = attn_ref.attention_bwd(*(t.detach() for t in ts), out.detach(),
                                  torch.tensor(g), window=3)
    for t, w_ in zip(ts, want):
        assert torch.equal(t.grad, w_)


def test_backward_entry_points_refuse_what_they_cannot_take():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="does not match"):
        rms.rmsnorm_bwd(x, torch.ones(8), torch.ones(2, 4))
    with pytest.raises(ValueError, match="no RMSNorm kernel"):
        rms.rmsnorm_bwd(x.to("meta"), torch.ones(8, device="meta"),
                        x.to("meta"))
    q = torch.ones(1, 2, 3, 16)
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention_bwd(q, q, q, q, q[:, :, :2])
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        m = q.to("meta")
        fa.flash_attention_bwd(m, m, m, m, m)


# (kind, load, vec, vectors a thread, threads a row, consumer warps, rows
# a stage, stages)
LOOP = ("loop", "", 1, 0, 256, 0, 0, 0)


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (128, torch.bfloat16, True, ("ring", "map", 8, 2, 8, 8, 64, 3)),  # q, k
    (5120, torch.bfloat16, True, ("ring", "bulk", 8, 2, 320, 10, 2, 2)),
    (5120, torch.float32, True, ("ring", "bulk", 4, 4, 320, 10, 1, 2)),
    (7168, torch.float32, True, ("ring", "bulk", 4, 8, 224, 7, 1, 2)),
    (37, torch.float32, True, LOOP),                    # ragged width
    (64, torch.bfloat16, False, LOOP),                  # unaligned
    (20000, torch.float32, True, LOOP),                 # two stages too wide
    (1280, torch.bfloat16, True, ("ring", "bulk", 8, 1, 160, 5, 6, 3)),
    (128, torch.float32, True, ("ring", "map", 4, 2, 16, 8, 32, 3)),
    (256, torch.float32, True, ("ring", "map", 4, 2, 32, 8, 16, 3)),
    (8, torch.bfloat16, True, ("ring", "map", 8, 1, 1, 4, 256, 8)),
])
def test_backward_launch_plan(d, dtype, aligned, want):
    plan = rms.bwd_plan(d, dtype, aligned)
    assert (plan.kind, plan.load, plan.vec, plan.vpt, plan.tpr, plan.warps,
            plan.rows, plan.stages) == want
    if plan.kind == "loop":
        assert plan.smem == 0 and plan.block == rms.BWD_LOOP_BLOCK
        return
    row = d * dtype.itemsize
    # every vector of the row has a thread; the ring's stages, each tensor's
    # rows on 128 bytes, fit the 227 KB a block can use beside its static
    # shared memory (barriers, row sums, dw's final sums: under 8 KB)
    assert plan.tpr * plan.vpt * plan.vec >= d and row % 16 == 0
    assert 2 <= plan.stages <= rms.BWD_MAX_STAGES
    assert plan.region % rms.SMEM_ALIGN == 0
    assert plan.region >= plan.rows * row
    assert plan.smem <= rms.BWD_MAX_RING + rms.SMEM_ALIGN <= (227 << 10) - 8192
    assert plan.block <= 32 * (rms.BWD_MAX_WARPS + 1)
    if plan.load == "map":
        # one TMA box a tensor: d columns of 16-byte multiples, at most 256
        # rows, every group of the stage walking the same rows
        assert d <= rms.BWD_MAP_MAX_D and plan.rows <= 256
        assert plan.tpr <= 32 and plan.tpr & (plan.tpr - 1) == 0
        assert plan.rows % (plan.groups * rms.bwd_rows_at_once(plan.vpt)) \
            == 0
        # the groups' dw shares meet in the drained ring
        assert plan.groups * d * 4 <= 2 * plan.stages * plan.region
    else:
        assert plan.tpr == 32 * plan.warps and plan.groups == 1
        assert plan.rows % rms.bwd_rows_at_once(plan.vpt) == 0


@pytest.mark.parametrize("d,dtype,n_rows,n2,bps,want", [
    (5120, torch.bfloat16, 4096, 4096, 2, 264),          # 2048 tiles
    (5120, torch.bfloat16, 100, 100, 2, 50),          # two rows a tile
    (128, torch.bfloat16, 163840, 2048, 2, 264),        # q view: 2560 tiles
    (128, torch.bfloat16, 32768, 2048, 2, 264),         # k view: 512 tiles
    (128, torch.bfloat16, 300, 100, 2, 6),              # 3 runs of 2 tiles
    (37, torch.float32, 6, 6, 3, 6),                     # loop: a row a block
    (20000, torch.float32, 5000, 5000, 1, 132),
])
def test_backward_grid_fits_the_resident_blocks(d, dtype, n_rows, n2, bps,
                                                want):
    """The cooperative launch's grid: a block a tile, no more than the SMs
    hold at once; a plan no SM can hold raises."""
    plan = rms.bwd_plan(d, dtype, True)
    grid = rms.bwd_grid(plan, n_rows, n2, 132, bps)
    assert grid == want and 1 <= grid <= min(132 * bps,
                                             rms.bwd_tiles(plan, n_rows, n2))
    with pytest.raises(ValueError, match="does not fit"):
        rms.bwd_grid(plan, n_rows, n2, 132, 0)


def _heads(b, s, h, d, dtype):
    """The transposed heads view (B, H, S, D) of a (B, S, H*D) tensor."""
    return torch.empty((b, s, h * d), dtype=dtype).view(b, s, h, d) \
        .transpose(1, 2)


# phase (n1)'s cases of chip_smoke.py: (name, x, dy) → (route, n1, n2)
N1_CASES = [
    ("ln rows (2, 2048, 5120) bf16",
     lambda: torch.empty((2, 2048, 5120), dtype=torch.bfloat16),
     lambda x: torch.empty(x.shape, dtype=x.dtype), ("bulk", 1, 4096)),
    ("q heads view (2, 40, 2048, 128) bf16",
     lambda: _heads(2, 2048, 40, 128, torch.bfloat16),
     lambda x: torch.empty(x.shape, dtype=x.dtype), ("map", 40, 2048)),
    ("k heads view (2, 8, 2048, 128) bf16",
     lambda: _heads(2, 2048, 8, 128, torch.bfloat16),
     lambda x: torch.empty(x.shape, dtype=x.dtype), ("map", 8, 2048)),
    ("(4096, 5120) f32", lambda: torch.empty((4096, 5120)),
     lambda x: torch.empty(x.shape), ("bulk", 1, 4096)),
    ("(33, 7168) f32", lambda: torch.empty((33, 7168)),
     lambda x: torch.empty(x.shape), ("bulk", 1, 33)),
    ("(6, 37) f32", lambda: torch.empty((6, 37)),
     lambda x: torch.empty(x.shape), ("loop", 1, 6)),
    ("(5, 20000) f32", lambda: torch.empty((5, 20000)),
     lambda x: torch.empty(x.shape), ("loop", 1, 5)),
    ("(3, 7, 1280) bf16", lambda: torch.empty((3, 7, 1280),
                                              dtype=torch.bfloat16),
     lambda x: torch.empty(x.shape, dtype=x.dtype), ("bulk", 1, 21)),
]


@pytest.mark.parametrize("name,make_x,make_dy,want", N1_CASES,
                         ids=[c[0] for c in N1_CASES])
def test_backward_routes_of_the_card_cases(name, make_x, make_dy, want):
    """Each case phase (n1) runs on the card takes its route: the heads
    views through tensor maps over (B, H, S) in place, the wide rows by
    bulk copies, ragged and too-wide rows the loop kernel; dx keeps x's
    strides."""
    x = make_x()
    dw = torch.empty(x.shape[-1], dtype=x.dtype)
    dy, dx, (n_rows, (n1, n2), strides), aligned = rms.bwd_operands(
        x, make_dy(x), dw)
    plan = rms.bwd_plan(x.shape[-1], x.dtype, aligned)
    assert (plan.load or plan.kind, n1, n2) == want
    assert dx.stride() == x.stride() and strides[0] == strides[2]
    assert n_rows == x.numel() // x.shape[-1]


def test_dx_layout_rule():
    """dx keeps x's strides where x is non-overlapping and dense with unit
    stride along its rows, else it is contiguous; the CPU route hands dx
    back in that layout with the plain backward's values."""
    base = torch.randn(2, 6, 3 * 16)
    heads = base.view(2, 6, 3, 16).transpose(1, 2)
    cases = [(heads, heads.stride()),
             (base, base.stride()),
             (base.view(2, 6, 3, 16).permute(2, 0, 1, 3),
              (16, 3 * 6 * 16, 3 * 16, 1)),
             (base[..., :32], (6 * 32, 32, 1)),          # a slice: not dense
             (torch.randn(4, 16).expand(3, 4, 16), (64, 16, 1)),
             (torch.randn(16, 12).t(), (16, 1))]         # rows not unit stride
    for x, want in cases:
        assert rms.grad_like(x).stride() == want, (x.shape, x.stride())
    rng = np.random.default_rng(12)

    def rand(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    w = rand(16)
    wide = rand((2, 6, 32))
    for x in (rand((2, 6, 48)).view(2, 6, 3, 16).transpose(1, 2),
              rand((2, 6, 48)).view(2, 6, 3, 16).permute(2, 0, 1, 3),
              wide[..., :16], rand((4, 16)).expand(3, 4, 16)):
        dy = rand(x.shape)
        dx, dw = rms.rmsnorm_bwd(x, w, dy)
        ref_x, ref_w = rms_ref.rmsnorm_bwd(x, w, dy)
        assert dx.stride() == rms.grad_like(x).stride()
        assert torch.equal(dx, ref_x) and torch.equal(dw, ref_w)


def test_joint_row_layout_folds_what_nests_in_every_tensor():
    x = _heads(2, 5, 3, 16, torch.float32)               # (2, 3, 5, 16)
    dy = torch.empty(x.shape)                           # contiguous
    n_rows, (n1, n2), (sx, sd, sdx) = rms.joint_row_layout(x, dy,
                                                           rms.grad_like(x))
    assert (n_rows, n1, n2) == (30, 3, 5)
    assert sx == sdx == (5 * 48, 16, 48) and sd == (3 * 5 * 16, 5 * 16, 16)
    # contiguous alone: one dimension
    assert rms.joint_row_layout(dy) == (30, (1, 30), [(0, 0, 16)])
    # four row dimensions that do not nest do not fold
    x4 = torch.empty(2, 3, 5, 4, 8).permute(0, 1, 3, 2, 4)
    assert rms.joint_row_layout(x4)[1] == (4, 5)      # (2 x 3), (4), (5)
    with pytest.raises(ValueError, match="do not fold"):
        rms.joint_row_layout(torch.empty(5, 3, 2, 4, 8).permute(2, 1, 3, 0, 4))
    # x and dy that fold alone but not together: dy is copied contiguous,
    # and then the three fold along x's dimensions
    x = torch.empty(2, 3, 5, 4, 8).permute(0, 1, 3, 2, 4)
    dy = torch.empty(2, 4, 5, 3, 8).permute(0, 3, 1, 2, 4)
    assert rms._folds(x) and rms._folds(dy) and not rms._folds(x, dy)
    dyk, dx, (_, (n1, n2), strides), _ = rms.bwd_operands(x, dy,
                                                          torch.empty(8))
    assert dyk.is_contiguous() and dx.stride() == x.stride()
    assert strides[0] == strides[2] and strides[1][2] == 8


@gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -7)])
def test_kernels_gradients_equal_the_plain_routes_on_the_card(dtype, tol):
    """Through the kernels (the default route on the card) and through the
    plain versions (``impl="ref"``, autograd): each gradient within ``tol``
    of the largest plain one, the attention's in bfloat16 (the tensor-core
    backward) within :func:`tensor_core_bwd_limit` instead; every backward
    launches its kernel."""
    rng = np.random.default_rng(9)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), device="cuda",
                            dtype=torch.float32).to(dtype)

    y = t((2, 300, 5 * 128))
    x = y.view(2, 300, 5, 128).transpose(1, 2)      # a heads view
    w, dy = t((128,)), t((2, 5, 300, 128))
    q = t((2, 300, 8, 64)).transpose(1, 2)
    k, v = (t((2, 200, 2, 64)).transpose(1, 2) for _ in "kv")
    do = t((2, 8, 300, 64))

    def grads(impl):
        leaves = [a.detach().requires_grad_() for a in (x, w, q, k, v)]
        out = rms.rmsnorm(*leaves[:2], impl=impl)
        att = fa.flash_attention(*leaves[2:], impl=impl)
        return torch.autograd.grad((out, att), leaves, (dy, do))

    launches = (rms.rmsnorm_bwd.launches, fa.flash_attention_bwd.launches)
    got = grads(None)
    assert (rms.rmsnorm_bwd.launches, fa.flash_attention_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    assert got[0].stride() == x.stride()            # dx in the view's layout
    want = grads("ref")
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
    tensor_cores = dtype == torch.bfloat16
    for g, r in zip(got[:2] if tensor_cores else got,
                    want[:2] if tensor_cores else want):
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max())
    if tensor_cores:
        o = attn_ref.attention(q, k, v)
        limits = tensor_core_bwd_limit(q, k, v, o, do, want[2:])
        assert _share(got[2:], want[2:], limits) <= 1.0
    again = grads(None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@gpu
def test_heads_view_backward_launches_one_kernel_and_copies_nothing(
        tmp_path):
    """RMSNorm on ``_split_heads``' view of a projection: autograd's
    backward runs the ring kernel once and, dx keeping the view's strides,
    no copy back to (B, S, H*D); the gradient equals the plain one.  The
    kernels are read from the profiler's Chrome trace."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import _split_heads
    rng = np.random.default_rng(10)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), device="cuda",
                            dtype=torch.float32).to(torch.bfloat16)
    y, w, dy = t((2, 300, 5 * 128)).requires_grad_(), t((128,)), \
        t((2, 5, 300, 128))
    out = rms.rmsnorm(_split_heads(y, 5, 128), w)
    torch.cuda.synchronize()
    # a session whose trace holds no kernel event at all is run again, up
    # to three (on an H100, after torch.compile and the benchmark suites
    # had run in a process, its short profiler sessions recorded none)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            (gy,) = torch.autograd.grad(out, y, dy, retain_graph=True)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        kernels = [e["name"] for e in json.loads(
            (tmp_path / "trace.json").read_text())["traceEvents"]
            if e.get("cat") == "kernel"]
        if kernels:
            break
    assert len(kernels) == 1 and "rmsnorm_bwd_ring" in kernels[0], kernels
    want = rms_ref.rmsnorm_bwd(_split_heads(y.detach(), 5, 128), w, dy)[0]
    want = want.transpose(1, 2).reshape(y.shape).float()
    err = float((gy.float() - want).abs().max())
    assert err <= 2 ** -7 * float(want.abs().max())


@gpu
@pytest.mark.parametrize("shape,dtype,heads", [
    ((2, 300, 5, 128), torch.bfloat16, True),
    ((300, 5120), torch.bfloat16, False),
    ((33, 7168), torch.float32, False),
    ((3, 77, 4, 64), torch.float32, True),
], ids=str)
def test_ring_backward_is_deterministic_and_catches_its_faults(shape, dtype,
                                                               heads):
    """Two runs bit-equal and within the limit of the plain backward (2^-7
    of max |plain| in bfloat16, 1e-4 in float32); each planted fault of
    the ring kernel beyond it."""
    rng = np.random.default_rng(11)

    def t(s):
        return torch.tensor(rng.standard_normal(s), device="cuda",
                            dtype=torch.float32).to(dtype)
    x = t(shape).transpose(1, 2) if heads else t(shape)
    w, dy = t((shape[-1],)), t(x.shape)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4

    def err(got, want):
        return float((got.float() - want.float()).abs().max()) / float(
            want.float().abs().max())
    got, again = rms.rmsnorm_bwd(x, w, dy), rms.rmsnorm_bwd(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = rms_ref.rmsnorm_bwd(x, w, dy)
    assert max(err(g, r) for g, r in zip(got, want)) <= tol
    for fault, code in rms.BWD_FAULTS.items():
        bad = rms._launch_bwd(x, w, dy, 1e-6, fault=code)
        errs = [err(g, r) if torch.isfinite(g.float()).all() else 1.0
                for g, r in zip(bad, want)]
        assert max(errs) > tol, fault


# ------------------------------------------------- the tensor-core backward
def _softmax_parts(q, k, v, o, do, causal, window):
    """P, dS, the mask, and the query/key operands grouped, in float32."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    logits, qf, mask = attn_ref._masked_logits(q, k, causal, window, None)
    p = torch.softmax(logits, dim=-1)
    dof, of = (t.float().reshape(b, hkv, g, sq, d) for t in (do, o))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    di = (dof * of).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dp - di), 0.0)
    return p, ds, mask, dof, of


def tensor_core_bwd_limit(q, k, v, o, do, want, *, causal=True,
                          window=None):
    """The tensor-core backward's limit against ``want`` (the plain
    backward's or autograd's gradients), elementwise: 1e-5 max|want| +
    2^-7 |want| + 2^-7 plain(|.|), plain(|.|) = (scale |dS'| |k|, scale
    |dS'|^T |q|, P^T |do|) with |dS'| = |dS| + P rowsum(|do| |o|): twice the
    unit roundoff of P and dS in bfloat16 over the products that take
    them, and of Di against autograd's unrounded output."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    p, ds, mask, dof, of = _softmax_parts(q, k, v, o, do, causal, window)
    ds_abs = ds.abs() + torch.where(
        mask, p * (dof.abs() * of.abs()).sum(-1, keepdim=True), 0.0)
    scale = d ** -0.5
    absq = q.float().abs().reshape(ds.shape[:3] + (sq, d))
    plain_abs = (
        scale * torch.einsum("bhgqk,bhkd->bhgqd", ds_abs, k.float().abs())
        .reshape(b, hq, sq, d),
        scale * torch.einsum("bhgqk,bhgqd->bhkd", ds_abs, absq),
        torch.einsum("bhgqk,bhgqd->bhkd", p, dof.abs()))
    a, r, ra = BWD_TC_LIMIT
    return [a * float(w.float().abs().max()) + r * w.float().abs() + ra * pa
            for w, pa in zip(want, plain_abs)]


def tensor_core_bwd_emulation(q, k, v, o, do, *, causal=True, window=None,
                              fault=None):
    """The tensor-core backward's arithmetic, plain: float32 products of
    bfloat16 operands, P and dS rounded to bfloat16 before dv = P^T do, dk
    = scale dS^T q and dq = scale dS k, each gradient rounded to bfloat16.
    ``fault`` plants one of the kernel's two planted faults."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    p, ds, mask, dof, _ = _softmax_parts(q, k, v, o, do, causal, window)
    if fault == "dS not zeroed under the mask":
        logits, _, _ = attn_ref._masked_logits(q, k, False, None, None)
        m = torch.where(mask, logits, attn_ref.NEG_INF).amax(-1, True)
        l = torch.exp(torch.where(mask, logits, attn_ref.NEG_INF) - m) \
            .sum(-1, True)
        raw = torch.exp(logits - m) / l
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
        di = (dof * o.float().reshape(dof.shape)).sum(-1, keepdim=True)
        ds = torch.where(mask, ds, raw * (dp - di))
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    qf = q.float().reshape(dof.shape)
    if fault == "last query head of each group left out of dK/dV":
        keep = torch.ones(hq // hkv)
        keep[-1] = 0
        pk, dsk = (t * keep[:, None, None] for t in (pb, dsb))
    else:
        pk, dsk = pb, dsb
    scale = d ** -0.5
    dq = scale * torch.einsum("bhgqk,bhkd->bhgqd", dsb, k.float())
    dk = scale * torch.einsum("bhgqk,bhgqd->bhkd", dsk, qf)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", pk, dof)
    return tuple(t.to(torch.bfloat16) for t in
                 (dq.reshape(b, hq, sq, d), dk, dv))


# (b, hq, hkv, sq, skv, d, causal, window): head dims 64, 112 and 128,
# causal, windowed, not causal with Sq != Skv, rows that see no key, GQA
# groups 1, 5 and 16
TC_BWD_CASES = [
    (1, 10, 2, 300, 300, 128, True, None),
    (1, 10, 2, 256, 256, 128, True, 64),
    (1, 8, 8, 200, 330, 64, False, None),
    (1, 16, 16, 200, 130, 112, True, None),
    (1, 16, 1, 130, 130, 128, True, None),
    (1, 4, 4, 129, 257, 64, False, 100),
    (2, 10, 2, 77, 77, 112, True, 16),
]


def _bwd_inputs(case, seed, device="cpu"):
    b, hq, hkv, sq, skv, d, causal, window = case
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=device).to(torch.bfloat16)
    q = t((b, sq, hq, d)).transpose(1, 2)          # heads views
    k, v = (t((b, skv, hkv, d)).transpose(1, 2) for _ in "kv")
    do = t((b, sq, hq, d)).transpose(1, 2)
    return q, k, v, do


def _share(got, want, limits):
    """The largest |got - want| / limit; inf where got is not finite."""
    if not all(bool(torch.isfinite(g.float()).all()) for g in got):
        return float("inf")
    return max(float(((g.float() - w.float()).abs() / lim).max())
               for g, w, lim in zip(got, want, limits))


@pytest.mark.parametrize("case", TC_BWD_CASES, ids=str)
def test_tensor_core_bwd_arithmetic_lies_within_its_limit(case):
    """The emulated tensor-core backward within its limit of the plain
    backward and of autograd through the plain forward, in bfloat16."""
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v, do = _bwd_inputs(case, seed=21)
    kw = dict(causal=causal, window=window)
    o = attn_ref.attention(q, k, v, **kw)
    got = tensor_core_bwd_emulation(q, k, v, o, do, **kw)
    want = attn_ref.attention_bwd(q, k, v, o, do, **kw)
    ts = [a.detach().requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(attn_ref.attention(*ts, **kw), ts, do)
    for w in (want, auto):
        share = _share(got, w, tensor_core_bwd_limit(q, k, v, o, do, w,
                                                     **kw))
        assert share <= 1.0, share


@pytest.mark.parametrize("case,fault", [
    (case, fault) for case in TC_BWD_CASES for fault in fa.BWD_FAULTS
    if case[6] or case[7] or not fault.startswith("dS")], ids=str)
def test_tensor_core_bwd_limit_catches_planted_faults(case, fault):
    """Each planted fault exceeds the limit wherever it can show: the
    mask's where the case masks a pair."""
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v, do = _bwd_inputs(case, seed=21)
    kw = dict(causal=causal, window=window)
    o = attn_ref.attention(q, k, v, **kw)
    bad = tensor_core_bwd_emulation(q, k, v, o, do, fault=fault, **kw)
    want = attn_ref.attention_bwd(q, k, v, o, do, **kw)
    assert _share(bad, want, tensor_core_bwd_limit(q, k, v, o, do, want,
                                                   **kw)) > 1.0


@gpu
@pytest.mark.parametrize("case", TC_BWD_CASES, ids=str)
def test_tensor_core_backward_on_the_card(case):
    """The wgmma backward (three launches) against the plain backward and
    autograd through the plain forward within its limit, given the
    forward kernel's statistics as autograd gives them; two runs
    bit-equal; each planted fault exceeds the limit where it can show."""
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v, do = _bwd_inputs(case, seed=22, device="cuda")
    kw = dict(causal=causal, window=window)
    stats = torch.empty((2, b, hq, sq), device="cuda")
    o = fa._launch(q, k, v, route="wgmma", stats=stats, **kw)
    before = fa.flash_attention_bwd.launches_by_route["wgmma"]
    got = fa.flash_attention_bwd(q, k, v, o, do, stats=stats, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, stats=stats, **kw)
    assert fa.flash_attention_bwd.launches_by_route["wgmma"] == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = attn_ref.attention_bwd(q, k, v, o, do, **kw)
    ts = [a.detach().requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(attn_ref.attention(*ts, **kw), ts, do)
    for w in (want, auto):
        assert _share(got, w, tensor_core_bwd_limit(q, k, v, o, do, w,
                                                    **kw)) <= 1.0
    limits = tensor_core_bwd_limit(q, k, v, o, do, want, **kw)
    for fault, code in fa.BWD_FAULTS.items():
        if code == 1 and not (causal or window):
            continue
        bad = fa._launch_bwd(q, k, v, o, do, stats, route="wgmma",
                             fault=code, **kw)
        assert _share(bad, want, limits) > 1.0, fault
    # without statistics the wrapper runs the forward for them
    assert all(torch.equal(a, c) for a, c in zip(
        got, fa.flash_attention_bwd(q, k, v, o, do, **kw)))


# the SIMT backward at every (dtype, head dim) of its route and three
# shapes: (b, hq, hkv, sq, skv, causal, window)
SIMT_ROUTE = [(dt, d) for dt in (torch.float32, torch.bfloat16)
              for d in fa.HEAD_DIMS if fa.route(dt, d) == "simt"]
SIMT_BWD_SHAPES = {"ragged, window": (2, 8, 2, 130, 200, True, 24),
                   "rows that see no key": (1, 6, 2, 150, 70, True, None),
                   "not causal, Sq < Skv": (1, 4, 4, 77, 333, False, None)}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@gpu
@pytest.mark.parametrize("shape", SIMT_BWD_SHAPES)
@pytest.mark.parametrize("dtype,d", SIMT_ROUTE, ids=str)
def test_simt_backward_on_the_card(dtype, d, shape):
    """The SIMT backward (two launches) on heads views, given the SIMT
    forward's statistics: each gradient within BWD_TOL of the largest
    plain one, against the plain backward and autograd through the plain
    forward; two runs bit-equal; each planted fault beyond the limit
    wherever it can show (the mask's where the shape masks a pair)."""
    b, hq, hkv, sq, skv, causal, window = SIMT_BWD_SHAPES[shape]
    rng = np.random.default_rng(d + 1)

    def heads(s, h):
        x = torch.tensor(rng.standard_normal((b, s, h * d)),
                         dtype=torch.float32, device="cuda")
        return x.to(dtype).view(b, s, h, d).transpose(1, 2)
    q, k, v, do = heads(sq, hq), heads(skv, hkv), heads(skv, hkv), \
        heads(sq, hq)
    kw = dict(causal=causal, window=window)
    stats = torch.empty((2, b, hq, sq), device="cuda")
    o = fa._launch(q, k, v, route="simt", stats=stats, **kw)
    before = fa.flash_attention_bwd.launches_by_route["simt"]
    got = fa.flash_attention_bwd(q, k, v, o, do, stats=stats, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, stats=stats, **kw)
    assert fa.flash_attention_bwd.launches_by_route["simt"] == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = attn_ref.attention_bwd(q, k, v, o, do, **kw)
    ts = [a.detach().requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(attn_ref.attention(*ts, **kw), ts, do)
    tol = BWD_TOL[dtype]

    def err(gs, ws):
        return max(float((g.float() - w.float()).abs().max())
                   / float(w.float().abs().max()) for g, w in zip(gs, ws))
    assert err(got, want) <= tol and err(got, auto) <= tol
    for fault, code in fa.BWD_FAULTS.items():
        if code == 1 and not (causal or window):
            continue
        bad = fa._launch_bwd(q, k, v, o, do, stats, route="simt", fault=code,
                             **kw)
        assert not err(bad, want) <= tol, fault
