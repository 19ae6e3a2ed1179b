"""The port's kernels (repro_torch.kernels) against the JAX package.

The plain PyTorch versions against the JAX Pallas kernels (in interpret
mode, as tests/test_kernels.py runs them) and the jnp oracles, on the same
numpy inputs, over the JAX sweep's shapes, dtypes and tolerances; and the
kernel wrappers' and the build's checks, which need no card.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import matmul as jax_matmul
from repro.kernels import rmsnorm as jax_rmsnorm
from repro.kernels import ref as jax_ref
from repro.models.layers import chunked_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (
    BK_TILES, HEAD_DIMS, ROWS, bwd_scratch, flash_attention_cuda, kv_tile,
    plan_flash, plan_flash_bwd)
from repro_torch.kernels.matmul import (A_STAGE_FLOATS, SKINNY_MAX_M,
                                        SKINNY_MAX_M_ROWB_BEYOND_L2,
                                        matmul_cuda, plan_matmul,
                                        skinny_max_m)
from repro_torch.kernels.rmsnorm import (MAX_NV, VARIANTS, plan_rmsnorm,
                                         rmsnorm_cuda, variants_for)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

MATMUL_SHAPES = [(128, 128, 128), (256, 512, 384), (64, 96, 32), (8, 8, 8),
                 (512, 128, 256)]
RMSNORM_SHAPES = [(4, 64, 128), (3, 37, 96), (1, 1, 8), (2, 200, 256)]
FLASH_DIMS = [(2, 128, 128, 4, 2, 64),     # square causal GQA
              (1, 64, 256, 8, 8, 32),      # suffix queries (Sq < Skv)
              (2, 256, 256, 6, 2, 64),     # multi-tile both ways
              (1, 96, 96, 3, 1, 16)]       # MQA, non-128 sizes


def _both(a: np.ndarray, dtype: str):
    """One numpy f32 array as a JAX array and a CPU torch tensor of
    ``dtype`` (both round to bf16 the same way: to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- plain versions vs the JAX package (CPU) ----------------------------------

@pytest.mark.parametrize("mkn", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas_and_ref(mkn, dtype):
    M, K, N = mkn
    rng = np.random.default_rng(7)
    ja, ta = _both(rng.standard_normal((M, K), np.float32), dtype)
    jb, tb = _both(rng.standard_normal((K, N), np.float32), dtype)
    got = _np(ops.matmul(ta, tb))
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for want in (jax_matmul(ja, jb), jax_ref.matmul_ref(ja, jb)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(7)
    jx, tx = _both(rng.standard_normal(shape, np.float32), dtype)
    jw, tw = _both((rng.standard_normal(shape[-1:]) * 0.1)
                   .astype(np.float32), dtype)
    got = _np(ops.rmsnorm(tx, tw))
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    for want in (jax_rmsnorm(jx, jw), jax_ref.rmsnorm_ref(jx, jw)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dims", FLASH_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(dims, dtype):
    B, Sq, Skv, H, KVH, d = dims
    rng = np.random.default_rng(7)
    jq, tq = _both(rng.standard_normal((B, Sq, H, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, Skv, KVH, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, Skv, KVH, d), np.float32), dtype)
    got = _np(ops.flash_attention(tq, tk, tv, causal=True))
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    for want in (jax_flash_attention(jq, jk, jv, causal=True),
                 jax_ref.flash_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)


def test_flash_attention_plain_matches_model_reference_path():
    """The port's attention and the JAX model's chunked_attention agree."""
    B, S, H, KVH, d = 2, 64, 4, 2, 32
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, S, n, d), np.float32)
               for n in (H, KVH, KVH))
    pos = jnp.arange(S)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=pos, kv_positions=pos, causal=True,
                             kv_chunk=16)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


def test_cpu_path_counts_no_launches():
    before = dict(ops.launches)
    x = torch.ones(3, 8)
    ops.rmsnorm(x, torch.zeros(8))
    ops.matmul(x, torch.ones(8, 2))
    ops.flash_attention(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 1, 8),
                        torch.ones(1, 4, 1, 8))
    assert ops.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never takes the plain path itself: the CPU choice
    is made in ops, by device, and a wrapper given CPU tensors raises."""
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(x, torch.ones(8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, torch.zeros(8))
    q = torch.ones(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])


def test_flash_wrapper_rejects_unsupported_shapes():
    q = torch.ones(1, 8, 2, 24)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q = torch.ones(1, 8, 2, 16)
    with pytest.raises(ValueError, match="Sq"):
        flash_attention_cuda(q, q[:, :4], q[:, :4])


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    """An edit to a kernel source or to the shared header renames its
    library, so a stale build is never loaded."""
    (tmp_path / "common.cuh").write_text("// a\n")
    (tmp_path / "k.cu").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    (tmp_path / "k.cu").write_text("// b2\n")
    second = _build._lib_path("k")
    (tmp_path / "common.cuh").write_text("// a2\n")
    third = _build._lib_path("k")
    assert len({first, second, third}) == 3
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


# -- the wrappers' path and geometry choice (plain Python, no card) -----------

# (M, K, N, B read along K): the serving path's shapes (smollm-135m: decode
# M = 4, prefill M = 31, prefill head M = 1 through embed.T), the tiled
# path's timing shapes, and awkward ones
PLAN_SHAPES = [(4, 576, 576, False), (4, 576, 192, False),
               (4, 576, 1536, False), (4, 1536, 576, False),
               (4, 576, 49152, True), (31, 576, 576, False),
               (31, 1536, 576, False), (1, 576, 49152, True),
               (2048, 576, 1536, False), (2048, 1536, 576, False),
               (1, 1, 1, False), (3, 7, 5, True), (4, 577, 576, False),
               (4, 576, 1, False), (300, 577, 129, True),
               (64, 100000, 8, False), (1 << 20, 64, 1 << 18, False)]
TDTYPES = [torch.float32, torch.bfloat16]


def _strides(M, K, N, colb):
    return (K, 1), ((1, K) if colb else (N, 1))


def _check_plan(plan, M, K, N):
    assert plan.path in ("skinny", "tiled")
    gx, gy = plan.grid
    assert 1 <= gx < 2 ** 31 and 1 <= gy < 2 ** 16
    if plan.path == "tiled":
        assert (gx, gy) == (-(-N // 128), -(-M // 128))
        return
    assert plan.grid[1] == plan.splits and 1 <= plan.grid[0] <= plan.tiles
    assert plan.kchunk % 32 == 0 and plan.mt * plan.kchunk <= A_STAGE_FLOATS
    # the splits cover K exactly: none empty, none missing
    assert plan.splits * plan.kchunk >= K
    assert (plan.splits - 1) * plan.kchunk < max(K, 1)
    assert plan.tiles >= -(-M // plan.mt)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", TDTYPES)
def test_matmul_plan_gives_every_shape_a_path(shape, dtype):
    M, K, N, colb = shape
    sa, sb = _strides(M, K, N, colb)
    plan = plan_matmul(M, K, N, sa, sb, dtype)
    _check_plan(plan, M, K, N)
    assert plan.path == ("skinny" if M <= skinny_max_m(K, N, dtype, colb)
                         else "tiled")


@pytest.mark.parametrize("dtype", TDTYPES)
@pytest.mark.parametrize("kn", [(576, 576), (1536, 576), (576, 49152)])
def test_matmul_plan_threshold_sides(dtype, kn):
    """Row-major B takes the table's threshold, except beyond the L2 (the
    tied head's backward dX), where it takes its own; B read along K (the
    tied head's embed.T) takes the table's."""
    K, N = kn
    in_l2 = 2 * K * N * (dtype.itemsize) <= 50e6
    for colb, sb in ((False, (N, 1)), (True, (1, K))):
        t = skinny_max_m(K, N, dtype, colb)
        assert t == (SKINNY_MAX_M_ROWB_BEYOND_L2[dtype]
                     if not (colb or in_l2) else SKINNY_MAX_M[dtype, in_l2])
        if dtype == torch.float32 or N != 49152 or not colb:
            # the serving path's decode (4), prefill (<= 31) and head (1)
            assert t >= 32
        assert plan_matmul(t + 1, K, N, (K, 1), sb, dtype).path == "tiled"
        if t:
            assert plan_matmul(t, K, N, (K, 1), sb, dtype).path == "skinny"
        assert plan_matmul(4, K, N, (K, 1), sb, dtype,
                           skinny_max=0).path == "tiled"


@pytest.mark.parametrize("K", [1, 31, 32, 33, 64, 577, 1536, 4096, 100003])
@pytest.mark.parametrize("N", [1, 192, 576, 49152])
def test_matmul_plan_split_k_covers_k(K, N):
    for dtype in TDTYPES:
        for colb in (False, True):
            sa, sb = _strides(4, K, N, colb)
            plan = plan_matmul(4, K, N, sa, sb, dtype)
            _check_plan(plan, 4, K, N)
            if plan.tiles >= 264:         # enough blocks: no split needed
                assert plan.splits == -(-K // plan.kchunk)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", TDTYPES)
def test_matmul_plan_params_carry_the_kernels_tiles(shape, dtype):
    """The C parameter block holds the tile count that sizes the split-K
    counters and the tile width the kernel derives (csrc BN), so a launch
    can refuse a plan that disagrees with the kernel."""
    M, K, N, colb = shape
    sa, sb = _strides(M, K, N, colb)
    plan = plan_matmul(M, K, N, sa, sb, dtype)
    assert len(plan.params) == 17
    assert tuple(plan.params[15:]) == (plan.tiles, plan.bn)
    if plan.path == "skinny":
        V = 16 // torch.empty((), dtype=dtype).element_size()
        bn = (8 * (8 if plan.mt <= 4 else 4)) if plan.colb else 32 * V
        assert plan.bn == bn
        assert plan.tiles == -(-M // plan.mt) * -(-N // bn)


@pytest.mark.parametrize("sms", [1, 66, 132, 144])
def test_matmul_plan_follows_the_sm_count(sms):
    """The skinny grid is sized from the card's SM count: at most two
    blocks per SM for each K split, and K split until the grid has about
    that many."""
    for M, K, N, colb in PLAN_SHAPES:
        if M > skinny_max_m(K, N, torch.float32, colb):
            continue
        sa, sb = _strides(M, K, N, colb)
        plan = plan_matmul(M, K, N, sa, sb, torch.float32, sms=sms)
        _check_plan(plan, M, K, N)
        assert plan.grid[0] == min(plan.tiles, 2 * sms)


def test_matmul_plan_small_n_splits_k_to_fill_the_card():
    """Where N gives few tiles, K is split until the grid reaches two
    blocks per SM or the splits reach their least depth (64 rows)."""
    for N in (192, 576):
        plan = plan_matmul(4, 1536, N, (1536, 1), (N, 1), torch.float32)
        assert plan.splits > 1
        assert plan.tiles * plan.splits >= min(264, plan.tiles * 1536 // 64)


@pytest.mark.parametrize("M", [4, 200])
@pytest.mark.parametrize("dtype", TDTYPES)
def test_matmul_plan_misaligned_picks_scalar_loads(M, dtype):
    K, N = 96, 72
    ok = plan_matmul(M, K, N, (K, 1), (N, 1), dtype)
    assert ok.vec
    for args in ((True, False), (False, False)):
        assert not plan_matmul(M, K, N, (K, 1), (N, 1), dtype, *args).vec
    # a row stride that is no multiple of the 16-byte vector
    assert not plan_matmul(M, K, 73, (K, 1), (73, 1), dtype).vec
    # the tiled path also loads A by vectors; the skinny path stages A
    # element by element and does not care
    a_off = plan_matmul(M, K, N, (K, 1), (N, 1), dtype, False, True)
    assert a_off.vec == (a_off.path == "skinny")


def test_matmul_plan_tied_head_reads_along_k():
    """The tied head's B is embed.T: unit stride along K, read in place."""
    embed = torch.zeros(49152, 576)
    w = embed.T
    plan = plan_matmul(4, 576, 49152, (576, 1), w.stride(), torch.float32)
    assert plan.colb and plan.vec and plan.path == "skinny"
    rowb = plan_matmul(4, 576, 49152, (576, 1), (49152, 1), torch.float32)
    assert not rowb.colb


@pytest.mark.parametrize("hk", [(9, 3), (4, 4), (16, 2), (8, 1), (72, 1),
                                (130, 1)])
@pytest.mark.parametrize("Sq", [1, 31, 256, 2048])
def test_flash_plan_groups_query_heads(hk, Sq):
    """One block carries the query heads of a KV head's group (all of them
    where they fit in its rows), and the grid covers every (position,
    head) exactly."""
    H, KVH = hk
    G = H // KVH
    q = torch.zeros(2, Sq, H, 64)
    k = torch.zeros(2, Sq, KVH, 64)
    plan = plan_flash(q, k, k)
    assert plan.gh * plan.bq <= ROWS and plan.gh <= G
    if G <= ROWS:
        assert plan.gh == G
    qtiles, gchunks = -(-Sq // plan.bq), -(-G // plan.gh)
    assert plan.grid == (qtiles * gchunks, KVH, 2)
    assert plan.vec


def test_flash_plan_misaligned_picks_scalar_loads():
    buf = torch.zeros(1 + 31 * 3 * 64)
    k = buf[1:].view(1, 31, 3, 64)
    q = torch.zeros(1, 31, 9, 64)
    assert not plan_flash(q, k, k).vec
    assert plan_flash(q, k.clone(), k.clone()).vec


# -- the flash backward plan (plain Python, no card) -------------------------

def _bwd_plan(B, Sq, Skv, H, KVH, d, dtype, bk=None, causal=True):
    q = torch.zeros(B, Sq, H, d, dtype=dtype)
    k = torch.zeros(B, Skv, KVH, d, dtype=dtype)
    return plan_flash_bwd(q, k, k, q, q, bk, causal=causal)


def bwd_blocks(plan):
    """grid.x in the kernel's order: ("kv", key tile, split) or ("q", row
    block).  Mirrors csrc/flash_attention_bwd.cu flash_bwd_kernel: of the
    first x blocks, ceil(x kv_blocks / N) are dK/dV blocks."""
    n1, N = plan.kv_blocks, plan.kv_blocks + plan.q_blocks
    for x in range(N):
        before, upto = -(-x * n1 // N), -(-(x + 1) * n1 // N)
        if upto > before:
            yield ("kv", before // plan.splits, before % plan.splits)
        else:
            yield ("q", plan.q_blocks - 1 - (x - before))


def bwd_rows(plan, kind, idx, split=0):
    """The (position, head) rows [begin, end) of a KV head that block
    (kind, idx[, split]) walks.  Mirrors csrc/flash_attention_bwd.cu
    split_rows (dQ: its own rows)."""
    nrows = plan.Sq * plan.G
    if kind == "q":
        return idx * plan.rows, min(idx * plan.rows + plan.rows, nrows)
    i0 = max(0, idx * plan.tile - (plan.Skv - plan.Sq)) if plan.causal else 0
    first = i0 * plan.G
    share = -(-(nrows - first) // plan.splits)
    per = -(-share // plan.rows) * plan.rows
    return (min(first + split * per, nrows),
            min(first + split * per + per, nrows))


def _bwd_work(plan, block):
    """Products x rows x keys of a block (causal): a dK/dV block 4 over its
    tile's keys and its rows, a dQ block 3 over its rows and the keys its
    last row sees."""
    kind, idx = block[0], block[1]
    b, e = bwd_rows(plan, kind, idx, *block[2:])
    if kind == "kv":
        return 4 * plan.tile * (e - b)
    last_pos = (e - 1) // plan.G
    return 3 * (e - b) * min(plan.Skv, plan.Skv - plan.Sq + last_pos + 1)


@pytest.mark.parametrize("hk", [(9, 3), (4, 4), (16, 2), (8, 1)])
@pytest.mark.parametrize("S", [(1, 1), (31, 31), (32, 32), (20, 300),
                               (2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", [16, 64])
def test_flash_bwd_plan_covers_every_key_tile_and_row_once(hk, S, dtype, bk):
    """Every key tile's splits cover, once, exactly the rows that see its
    first key; the dQ blocks cover every (position, head) row of a KV head
    once; the grid holds each block once."""
    (H, KVH), (Sq, Skv) = hk, S
    plan = _bwd_plan(2, Sq, Skv, H, KVH, 64, dtype, bk)
    G, nrows = H // KVH, Sq * H // KVH
    blocks = list(bwd_blocks(plan))
    assert plan.grid == (len(blocks), KVH, 2)
    ktiles = -(-Skv // plan.tile)
    assert sorted(b[1:] for b in blocks if b[0] == "kv") == \
        [(t, s) for t in range(ktiles) for s in range(plan.splits)]
    qbs = sorted(b[1] for b in blocks if b[0] == "q")
    assert qbs == list(range(plan.q_blocks))
    ranges = [bwd_rows(plan, "q", i) for i in qbs]
    assert ranges[0][0] == 0 and ranges[-1][1] == nrows
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    for t in range(ktiles):
        first = max(0, t * plan.tile - (Skv - Sq)) * G
        # the first row that sees key t * tile; the row before it sees none
        assert first == 0 or (first // G - 1) + Skv - Sq + 1 <= t * plan.tile
        parts = [bwd_rows(plan, "kv", t, s) for s in range(plan.splits)]
        assert parts[0][0] == first and parts[-1][1] == nrows
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        assert all((e - b) % plan.rows == 0 or e == nrows for b, e in parts)


@pytest.mark.parametrize("hk", [(9, 3), (16, 2), (8, 1)])
@pytest.mark.parametrize("S", [256, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_plan_launches_heaviest_first(hk, S, dtype):
    """Under the causal mask early key tiles and late row blocks carry the
    most work: along the grid each kind's work never rises from one tile
    (or row block) to the next, the grid opens with the heaviest key tile,
    and no block weighs much more than the heaviest dQ block (the plan
    cuts long key tiles to about its weight)."""
    H, KVH = hk
    plan = _bwd_plan(1, S, S, H, KVH, 64, dtype, 64)
    blocks = list(bwd_blocks(plan))
    assert blocks[0] == ("kv", 0, 0)
    tiles = [b[1] for b in blocks if b[0] == "kv"]
    assert tiles == sorted(tiles)
    tile_work = [sum(_bwd_work(plan, ("kv", t, s))
                     for s in range(plan.splits)) for t in sorted(set(tiles))]
    assert all(a >= b for a, b in zip(tile_work, tile_work[1:]))
    q_work = [_bwd_work(plan, b) for b in blocks if b[0] == "q"]
    assert all(a >= b for a, b in zip(q_work[:-1], q_work[1:-1]))
    heaviest_q = max(q_work)
    assert max(_bwd_work(plan, b) for b in blocks) <= 2 * heaviest_q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", [None, 1, 16, 17, 32, 64, 100])
@pytest.mark.parametrize("Skv", [8, 32, 2048])
def test_flash_bwd_plan_tile_follows_kv_tile(dtype, bk, Skv):
    """The backward's KV tile is the forward's: the study's kv_chunk means
    the same in both."""
    plan = _bwd_plan(1, Skv, Skv, 9, 3, 64, dtype, bk)
    assert plan.tile == kv_tile(bk, Skv, dtype) in BK_TILES
    assert plan.dtype == dtype and plan.vec


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", BK_TILES)
def test_flash_bwd_plan_geometry(d, dtype, bk):
    """bf16: 4 warps of 16 rows (mma.sync); f32: 4 x 4 keys x rows a thread,
    64 rows a chunk (4 x 2 and 32 rows at d 128); one split at the tuning
    loop's shapes, several at a 2048-token prompt, with workspace and
    counters for them."""
    plan = _bwd_plan(2, 32, 32, 9, 3, d, dtype, bk)
    if dtype == torch.bfloat16:
        assert (plan.warps, plan.rows) == (4, 64)
    else:
        tile_rows = 2 if d > 64 else 4
        assert plan.rows == (32 if d > 64 else 64)
        assert plan.warps * 32 * 4 * tile_rows == plan.tile * plan.rows
    assert plan.splits == 1
    assert bwd_scratch(2, 3, 32, plan.tile, plan.splits, d) == (0, 0)
    assert plan.q_blocks == -(-32 * 3 // plan.rows)
    long = _bwd_plan(1, 2048, 2048, 9, 3, d, dtype, 64)
    assert long.splits > 1
    ws_floats, counters = bwd_scratch(1, 3, 2048, long.tile, long.splits, d)
    assert counters == 3 * (2048 // 64)
    assert ws_floats == counters * long.splits * 2 * 64 * d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_plan_misaligned_or_strided_takes_element_loads(dtype):
    """vec (cp.async) needs every q/k/v/o/dO row 16-byte aligned: a k one
    element off, or a dO whose heads sit d + 1 apart, turn it off."""
    B, S, H, KVH, d = 1, 31, 9, 3, 64
    q = torch.zeros(B, S, H, d, dtype=dtype)
    k = torch.zeros(B, S, KVH, d, dtype=dtype)
    buf = torch.zeros(1 + k.numel(), dtype=dtype)
    off = buf[1:].view(B, S, KVH, d)
    wide = torch.zeros(B, S, H, d + 1, dtype=dtype)[..., :d]
    assert plan_flash_bwd(q, k, k, q, q).vec
    assert not plan_flash_bwd(q, off, k, q, q).vec
    assert not plan_flash_bwd(q, k, k, q, wide).vec
    assert not plan_flash_bwd(q, k, k, wide, q).vec
    # the forward's plan looks at q, k, v only
    assert plan_flash(q, k, k).vec


# -- the RMSNorm plan: variant and geometry (plain Python, no card) ----------

RMS_D = [1, 8, 96, 576, 577, 3072, 4096, 7168, 8192, 12000]
RMS_ROWS = [1, 4, 31, 2048, 8192]


def _rms_vec(dtype) -> int:
    return 16 // dtype.itemsize


def _check_rms_plan(plan, rows, D, dtype):
    """Each element of a row is taken by exactly one thread: the vector
    variants give each row the fewest vectors a thread that reach D, the
    scalar variant strides over D with no warp left idle."""
    assert plan.variant in VARIANTS
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    assert 1 <= plan.grid <= -(-rows // plan.rows_per_block)
    if plan.variant == "scalar":
        assert plan.nv == 0 and plan.rows_per_block == 1
        assert plan.threads <= -(-D // 32) * 32
        return
    V = _rms_vec(dtype)
    per_row = 32 if plan.variant == "warp" else plan.threads
    assert D % V == 0 and 1 <= plan.nv <= MAX_NV
    assert per_row * (plan.nv - 1) * V < D <= per_row * plan.nv * V
    if plan.variant == "warp":
        assert plan.threads == 32 * plan.rows_per_block
        assert plan.rows_per_block <= min(8, rows)
    else:
        assert plan.rows_per_block == 1


@pytest.mark.parametrize("D", RMS_D)
@pytest.mark.parametrize("dtype", TDTYPES)
def test_rmsnorm_plan_covers_each_element_once(D, dtype):
    V = _rms_vec(dtype)
    for rows in RMS_ROWS:
        for w_dtype in TDTYPES:
            plan = plan_rmsnorm(rows, D, D, dtype, w_dtype)
            _check_rms_plan(plan, rows, D, dtype)
            # the warp variant while a row fits a warp's registers, the
            # block variant beyond, element loads where D is no multiple
            # of the 16-byte vector
            want = ("scalar" if D % V else
                    "warp" if D // V <= 32 * MAX_NV else "block")
            assert plan.variant == want
        for variant in variants_for(D, D, dtype):
            _check_rms_plan(plan_rmsnorm(rows, D, D, dtype, dtype,
                                         variant=variant), rows, D, dtype)


def test_rmsnorm_plan_serving_shapes_take_a_warp_per_row():
    """smollm-135m's norms (decode 4 rows, prefill up to 31, of 576): a
    warp per row, 5 f32 vectors a lane (144 over 32 lanes, the last on
    half the lanes masked), 3 in bf16, decode in one block."""
    for dtype, nv in ((torch.float32, 5), (torch.bfloat16, 3)):
        dec = plan_rmsnorm(4, 576, 576, dtype, dtype)
        assert (dec.variant, dec.nv, dec.rows_per_block, dec.grid) == \
            ("warp", nv, 4, 1)
        pre = plan_rmsnorm(31, 576, 576, dtype, dtype)
        assert (pre.variant, pre.nv, pre.grid) == ("warp", nv, 8)


@pytest.mark.parametrize("dtype", TDTYPES)
def test_rmsnorm_plan_misaligned_picks_scalar_loads(dtype):
    V = _rms_vec(dtype)
    D = 64 * V
    assert plan_rmsnorm(4, D, D, dtype, dtype).variant == "warp"
    # a pointer off 16 bytes, a row stride no multiple of the vector, and
    # a D no multiple of it
    assert plan_rmsnorm(4, D, D, dtype, dtype, False).variant == "scalar"
    assert plan_rmsnorm(4, D, D + 1, dtype, dtype).variant == "scalar"
    assert plan_rmsnorm(4, D + 1, D + 1, dtype, dtype).variant == "scalar"
    # a strided view whose stride keeps the vectors aligned stays vector
    assert plan_rmsnorm(4, D, 3 * D, dtype, dtype).variant == "warp"
    assert variants_for(D, D + 1, dtype) == ("scalar",)
    with pytest.raises(ValueError, match="warp variant cannot"):
        plan_rmsnorm(4, D, D, dtype, dtype, False, variant="warp")
    with pytest.raises(ValueError, match="block variant cannot"):
        plan_rmsnorm(4, 4096 * V + V, 4096 * V + V, dtype, dtype,
                     variant="block")


@pytest.mark.parametrize("sms", [1, 66, 132, 144])
def test_rmsnorm_plan_follows_the_sm_count(sms):
    """The grid walks rows with a grid-stride loop and stops at what the
    SMs hold (2048 threads each), so it fills the card at many rows."""
    for D in (576, 577, 4096):
        for rows in (4, 31, 2048, 8192, 1 << 20):
            plan = plan_rmsnorm(rows, D, D, torch.float32, torch.float32,
                                sms=sms)
            _check_rms_plan(plan, rows, D, torch.float32)
            assert plan.grid == min(-(-rows // plan.rows_per_block),
                                    sms * (2048 // plan.threads))
    # 8-warp blocks once the rows fill every SM that way, else 4 warps
    many = plan_rmsnorm(8 * sms, 576, 576, torch.float32, torch.float32,
                        sms=sms)
    few = plan_rmsnorm(4 * sms, 576, 576, torch.float32, torch.float32,
                       sms=sms)
    assert (many.rows_per_block, few.rows_per_block) == (8, 4)


@pytest.mark.parametrize("shape", [(4, 576, 576), (31, 576, 1152),
                                   (37, 577, 577), (3, 7168, 7168),
                                   (8192, 4096, 4096), (1, 8, 8)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_rmsnorm_plan_params_carry_the_plan(shape, dtypes):
    """The C parameter block holds the shape, both dtypes (w is read in
    its own) and the plan's geometry, which the launch checks against what
    the kernel derives."""
    rows, D, stride = shape
    dtype, w_dtype = dtypes
    plan = plan_rmsnorm(rows, D, stride, dtype, w_dtype)
    assert tuple(plan.params) == (
        rows, D, stride, D, _build.DTYPE_CODES[dtype],
        _build.DTYPE_CODES[w_dtype], VARIANTS[plan.variant], plan.nv,
        plan.threads, plan.rows_per_block, plan.grid)


def test_rmsnorm_wrapper_refuses_other_weight_dtypes():
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.ones(4, 8), torch.zeros(8, dtype=torch.float16))
    with pytest.raises(ValueError, match="w shape"):
        rmsnorm_cuda(torch.ones(4, 8), torch.zeros(9))
