"""The non-fused trace kernel on the card: csrc/trace_hits.cu against its
plain PyTorch version on the same CUDA tensors, in brute and culled mode,
primary and reflected, with a ragged brute ray count; cases aimed at the
kernel's walk (csrc/trace_hits_walk.cuh: four Gaussians a step, clusters
padded to 4, a two-stage copy ring, slots in shared memory, the
ray-independent terms once per Gaussian on blocks whose rays share an
origin): K 16 and 32, integer and non-integer exp_power, the backfacing
gate, ray and Gaussian counts that are not multiples of the block, of 4 or
of the cluster, blocks of primary rays (one origin) beside padded blocks
that are not, exact depth ties (also one at the K-th slot that a later hit
breaks, where the walk must keep what the plain version's drain keeps), Gaussians thin enough that |ld|^2 passes
2^126 (the walk's division instead of its fast reciprocal), clusters with
no valid Gaussian and empty list entries, and saturation exits before the first, after the first,
after a middle and before the last candidate; and the non-fused frame and
training step on the card against the CPU.  Needs a CUDA card and
nvcc; every test here skips without a card.  Imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_trace_hits_cuda.py

(--noconftest: the suite's conftest imports jax.)  The tests carry the
`cuda` marker.

Tolerances: the kernel and the plain version share float32 pair math
without FMA, float64 exp/pow/log1p and sums, and sort the kept hits by
(t, id), so every output is equal; frames and steps on cuda and cpu are
equal bit for bit (ops/precision.py).
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.camera_rays import (
    primary_ray_directions,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import (
    ROW_INV,
    ROW_MEAN,
    ROW_OPACITY,
    ROW_ROT,
    ROW_SF2,
    ROW_VALID,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
    trace_hits,
    trace_hits_reference,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as gs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)

# every test here needs the card; each decides in the `cuda` fixture
pytestmark = pytest.mark.cuda

FAR = 50.0
OUTPUTS = ("t", "ids", "alpha", "gaussval", "local_hit", "attrs", "log_T",
           "traversed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@functools.cache
def _scene(device, n=4096):
    return gs.from_arrays(**room_scene(n), pad_multiple=2048, device=device)


@functools.cache
def _gpack(device, cluster):
    _f, _a, gpack, cull, _s, _p = tr.prepare_render_inputs(
        _scene(device), rt.RenderSettings(), True, True, 256, cluster, 16)
    return gpack, cull["bounds"]


def _rays(kind, device, n_rays, W=40):
    """Primary rays of a W-wide frame in linear order, or reflected rays
    (random origins and directions inside the room)."""
    eye, c2w = room_camera()
    H = -(-n_rays // W)
    d = primary_ray_directions(W, H, 0.9, torch.tensor(c2w)).reshape(-1, 3)
    d = d[:n_rays].numpy()
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    if kind == "reflected":
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.tensor(np.ascontiguousarray(o), device=device),
            torch.tensor(np.ascontiguousarray(d), device=device))


# (mode, rays, K, cluster, candidates, ray count)
CASES = {
    "brute_primary_k32": ("brute", "primary", 32, 256, 0, 1280),
    "brute_reflected_k16_ragged": ("brute", "reflected", 16, 256, 0, 1000),
    "culled_primary_k32": ("culled", "primary", 32, 256, 12, 1280),
    "culled_reflected_k16_c128": ("culled", "reflected", 16, 128, 24, 1280),
}


def _trace(case, device, fn):
    mode, kind, K, cluster, mc, n_rays = case
    gpack, bounds = _gpack(device, cluster)
    o, d = _rays(kind, device, n_rays)
    near = 0.05 if kind == "primary" else 0.0
    secondary = 0.0 if kind == "primary" else 1.0
    cands = cnear = None
    if mode == "culled":
        cands, cnear, _n, _o, _t = culling.select_candidates(
            o, d, bounds, near, FAR, tile=256, max_clusters=mc)
    return fn(o, d, gpack, cands, cnear, near, FAR, 3.0, secondary, 0.1,
              0.9, max_hits=K, cluster=cluster, tile=256)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_hits_kernel_matches_reference(case, cuda):
    before = trace_hits.launches
    out = _trace(CASES[case], cuda, trace_hits)
    torch.cuda.synchronize()
    assert trace_hits.launches == before + 1
    ref = _trace(CASES[case], cuda, trace_hits_reference)
    out = out[:5] + out[6:]
    for name, a, b in zip(OUTPUTS[:5] + OUTPUTS[6:], out, ref):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert (out[0] < 1e37).any()


def _assert_equal(out, ref):
    """Kernel outputs (attrs dropped) equal to the plain version's, bit for
    bit."""
    out = out[:5] + out[6:]
    for name, a, b in zip(OUTPUTS[:5] + OUTPUTS[6:], out, ref):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def _design_inputs(case, device):
    """(rays_o, rays_d, gpack, candidates, cand_near, call kwargs) of
    DESIGN[case]."""
    (mode, kind, K, cluster, n_rays, n_gauss, tile, exp_power,
     special) = DESIGN[case]
    gpack, bounds = _gpack(device, 64 if cluster == 64 else 256)
    gpack = gpack[:, :n_gauss].clone()
    o, d = _rays(kind, device, n_rays)
    if special == "ties":
        # every odd column a copy of its even neighbour (ties inside a group
        # of 4), and the second half a copy of the first (ties across
        # clusters, inserted far apart)
        gpack[:, 1::2] = gpack[:, 0::2]
        half = n_gauss // 2
        gpack[:, half:2 * half] = gpack[:, :half]
    if special == "invalid_cluster":
        gpack[ROW_VALID, 7 * cluster:8 * cluster] = 0.0
    if special == "thin":
        _make_thin(gpack, o, d)
    gpack = gpack.contiguous()
    secondary = 0.0 if kind == "primary" else 1.0
    cands = cnear = None
    if mode == "culled" and special == "select":
        cands, cnear, _n, _o, _t = culling.select_candidates(
            o, d, bounds, 0.0, FAR, tile=tile, max_clusters=24)
    elif mode == "culled":
        # hand-made lists: random clusters, the all-invalid cluster 7 in
        # every list, empty entries (-1) inside the lists, near distances
        # ascending so that some tiles stop on their K-th hit
        rng = np.random.default_rng(9)
        T, mc, nc = n_rays // tile, 20, n_gauss // cluster
        lists = rng.integers(0, nc, size=(T, mc))
        lists[:, 3] = 7
        lists[rng.uniform(size=(T, mc)) < 0.15] = -1
        near = np.sort(rng.uniform(0.0, 8.0, size=(T, mc)), axis=1)
        cands = torch.tensor(lists, dtype=torch.int32, device=device)
        cnear = torch.tensor(near, dtype=torch.float32, device=device)
    kw = dict(max_hits=K, cluster=cluster, tile=tile,
              transmittance_threshold=0.01)
    args = (o, d, gpack, cands, cnear, 0.05 if kind == "primary" else 0.0,
            FAR, exp_power, secondary, 10.0 if secondary else 0.1, 0.9)
    return args, kw


# Gaussians so thin along the view axis (1 / scale 1e19) that a primary
# ray's |ld|^2 reaches 2^126, where the walk divides instead of taking its
# fast reciprocal: placed 0.08-0.3 ahead of the eye on the frame's mean view
# direction, inside and across groups of 4.  Their products overflow (sq is
# -inf), so each is hit at t ~ its distance with gaussval 1; a reciprocal
# flushed to 0 would put t at 0, before the near plane.
THIN = (1, 2, 5, 6, 7, 8, 300, 301)
THIN_INV = 1e19


def _view_axes(d):
    """The frame's mean view direction f and two unit axes across it."""
    f = d.mean(dim=0)
    f = f / f.norm()
    u = torch.linalg.cross(f, torch.tensor([0.0, 0.0, 1.0], device=f.device))
    u = u / u.norm()
    return f, u, torch.linalg.cross(f, u)


def _make_thin(gpack, o, d):
    f, u, w = _view_axes(d)
    eye = o[0]
    for n, k in enumerate(THIN):
        s = 0.08 + 0.22 * n / (len(THIN) - 1)
        gpack[ROW_MEAN:ROW_MEAN + 3, k] = eye + s * f
        for i, axis in enumerate((f, u, w)):        # column i of R: axis i
            gpack[ROW_ROT + i:ROW_ROT + 9:3, k] = axis
        gpack[ROW_INV:ROW_INV + 3, k] = torch.tensor([THIN_INV, 2.0, 2.0],
                                                     device=gpack.device)
        gpack[ROW_OPACITY, k] = 0.5
        gpack[ROW_SF2, k] = 1.0
        gpack[ROW_VALID, k] = 1.0


# (mode, rays, K, cluster, ray count, Gaussian count, tile, exp_power,
# special): brute pads rays to 256 and Gaussians to 256 with invalid columns;
# culled with a 50-Gaussian cluster stages 52 columns (two invalid) with
# 4-byte copies; tile 100 leaves a partial warp; backfacing reach 10 on
# reflected rays
DESIGN = {
    "brute_k32_ragged": ("brute", "primary", 32, 256, 1001, 4093, 256, 3.0,
                         ""),
    "brute_k16_pow2_5_backfacing": ("brute", "reflected", 16, 256, 777, 4096,
                                    256, 2.5, ""),
    "brute_k16_ties": ("brute", "primary", 16, 256, 512, 4096, 256, 2.0,
                       "ties"),
    "brute_k32_ties_pow2_5": ("brute", "reflected", 32, 256, 300, 4090, 256,
                              2.5, "ties"),
    "culled_k32_c50_tile100": ("culled", "primary", 32, 50, 1000, 4050, 100,
                               3.0, "invalid_cluster"),
    "culled_k16_c50_pow2_backfacing": ("culled", "reflected", 16, 50, 1000,
                                       4050, 200, 2.0, "invalid_cluster"),
    "culled_k16_c64_select": ("culled", "reflected", 16, 64, 1024, 4096, 128,
                              2.5, "select"),
    "brute_k16_thin": ("brute", "primary", 16, 256, 600, 4096, 256, 3.0,
                       "thin"),
}


@pytest.mark.parametrize("case", sorted(DESIGN))
def test_trace_hits_kernel_design_cases(case, cuda):
    args, kw = _design_inputs(case, cuda)
    before = trace_hits.launches
    out = trace_hits(*args, **kw)
    torch.cuda.synchronize()
    assert trace_hits.launches == before + 1
    ref = trace_hits_reference(*args, **kw)
    _assert_equal(out, ref)
    valid = ref[0] < 1e37
    assert valid.any()
    if DESIGN[case][8] == "ties":
        # exact ties among the kept hits
        t = torch.where(valid, ref[0], torch.nan)
        assert (t[:, 1:] == t[:, :-1]).any()
    if DESIGN[case][8] == "thin":
        # every ray whose |ld|^2 on the thin Gaussians is past 2^126 keeps
        # them all, which it hits only through the division
        f, _u, _w = _view_axes(args[1])
        ll = (THIN_INV * (args[1] @ f)).double() ** 2
        huge = ll >= 2.0 ** 126
        assert huge.any()
        thin = torch.tensor(THIN, device=cuda)
        kept = (torch.isin(ref[1], thin) & valid).sum(dim=1)
        assert (kept[huge] == len(THIN)).all()


# the boundary-tie case (boundary_tie_case) on the walk's paths: (mode, K,
# cluster, rays share the origin)
TIE_CASES = {
    "culled_k16_shared": ("culled", 16, 128, True),
    "culled_k32_apart": ("culled", 32, 128, False),
    "brute_k16_shared": ("brute", 16, 256, True),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_trace_hits_boundary_tie(case, cuda):
    """An exact tie at the K-th slot that a later hit breaks: the kernel
    keeps the Gaussian the plain version's drain keeps (A, not B), every
    output equal."""
    mode, K, cluster, shared = TIE_CASES[case]
    (o, d, gpack, _t, _f, cands, cnear), a, b = boundary_tie_tensors(
        cuda, K=K, cluster=cluster, shared=shared)
    if mode == "brute":
        cands = cnear = None
    args = (o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    kw = dict(max_hits=K, cluster=cluster, tile=TIE_RAYS)
    out = trace_hits(*args, **kw)
    ref = trace_hits_reference(*args, **kw)
    _assert_equal(out, ref)
    assert (ref[1] == a).any(dim=1).all() and not (ref[1] == b).any()


@pytest.mark.parametrize("K,rays,seed", [(16, "primary", 0),
                                         (32, "reflected", 1)])
def test_trace_hits_tie_stress(K, rays, seed, cuda):
    """tie_stress_inputs: most rays keep hits tied in depth bit for bit,
    and later clusters evict between them; the kernel keeps the plain
    version's Gaussians on every ray."""
    o, d, gpack, _t, _f, cands, cnear, kw = tie_stress_inputs(cuda, rays,
                                                               seed)
    args = (o, d, gpack, cands, cnear, 0.0, FAR, 3.0, 0.0, 0.1, 0.9)
    out = trace_hits(*args, max_hits=K, **kw)
    ref = trace_hits_reference(*args, max_hits=K, **kw)
    _assert_equal(out, ref)
    t = torch.where(ref[0] < 1e37, ref[0], torch.nan)
    assert (t[:, 1:] == t[:, :-1]).any(dim=1).float().mean() > 0.5


def _one_ray_tiles(o, d, rows, tile):
    """Rays in tiles of `tile` copies of one ray each: rows[i] for tile i."""
    idx = torch.tensor(rows, device=o.device).repeat_interleave(tile)
    return o[idx].contiguous(), d[idx].contiguous()


@pytest.mark.parametrize("where", ["before_first", "first_middle_last"])
def test_trace_hits_saturation_exits(where, cuda):
    """Culled tiles of one ray each stop on saturation where their lists
    say: a cluster that saturates the ray alone (heavy) among clusters it
    misses (light), first, fourth and seventh of 8, and a list of light
    clusters only; or, at threshold 1, before the first candidate."""
    gpack, _b = _gpack(cuda, 256)
    C = 256
    nc = gpack.shape[1] // C
    o, d = _rays("primary", cuda, 1280)
    ray = 16 * 40 + 20                           # near the frame's centre
    common = (0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    # this ray's log T over each cluster alone: tile i lists cluster i
    oo, dd = _one_ray_tiles(o, d, [ray] * nc, C)
    alone = trace_hits_reference(
        oo, dd, gpack, torch.arange(nc, dtype=torch.int32,
                                    device=cuda)[:, None],
        torch.full((nc, 1), -np.inf, device=cuda), *common,
        transmittance_threshold=0.0, max_hits=16, cluster=C, tile=C)
    log_c = alone[5].view(nc, C)[:, 0]
    heavy = int(torch.argmin(log_c))
    light = [c for c in range(nc) if log_c[c].item() == 0.0]
    assert log_c[heavy].item() < -0.5 and light
    L = light[0]
    lists = [[heavy] + [L] * 7, [L] * 3 + [heavy] + [L] * 4,
             [L] * 6 + [heavy, L], [L] * 8]
    processed = [1, 4, 7, 8]
    thr = float(np.exp(log_c[heavy].item() / 2))
    if where == "before_first":
        thr, processed = 1.0, [0, 0, 0, 0]
    oo, dd = _one_ray_tiles(o, d, [ray] * len(lists), C)
    cands = torch.tensor(lists, dtype=torch.int32, device=cuda)
    cnear = torch.full(cands.shape, -np.inf, device=cuda)
    kw = dict(transmittance_threshold=thr, max_hits=16, cluster=C, tile=C)
    out = trace_hits(oo, dd, gpack, cands, cnear, *common, **kw)
    ref = trace_hits_reference(oo, dd, gpack, cands, cnear, *common, **kw)
    _assert_equal(out, ref)
    n_valid = gpack[ROW_VALID].view(nc, C).sum(dim=1)
    for tile, (lst, n) in enumerate(zip(lists, processed)):
        want = int(sum(n_valid[c].item() for c in lst[:n]))
        assert ref[6][tile * C].item() == want, (tile, n)



# The walk's design cases for the render and slots kernels, which share it
# (tests/test_torch_render_kernel_cuda.py, tests/test_torch_train_cuda.py).


@functools.cache
def _tables(device, cluster):
    """gpack, cluster bounds, and the slots kernel's attribute and frame
    tables of _scene's room in the culled layout."""
    _f, _a, gpack, cull, _s, _p = tr.prepare_render_inputs(
        _scene(device), rt.RenderSettings(), True, True, 256, cluster, 16)
    return gpack, cull["bounds"], cull["table"], cull["ftable"]


def walk_design_inputs(device, rays, cluster, tile, n_rays, n_gauss, lists,
                       special):
    """(rays_o, rays_d, gpack, table, ftable, candidates, cand_near, near)
    of a walk design case.  rays: "primary" (one origin), "reflected",
    "mixed" (primary, with one ray of every other block moved off the eye:
    blocks that share an origin beside blocks that do not), or "ulp" (as
    mixed, moved by one ulp).  lists:
    "select" (select_candidates, 24 a tile), "hand" (random lists of 20
    holding the all-invalid cluster 7 and empty entries, near distances
    ascending, so that tiles stop on their K-th hit) or "all" (every
    cluster for every tile at near -INF: every pair tested).  special: ""
    or "ties", "invalid_cluster", "thin" as in DESIGN.  n_gauss not a
    multiple of 4 stages with 4-byte copies."""
    gpack, bounds, table, ftable = _tables(
        device, cluster if lists == "select" else 256)
    gpack = gpack[:, :n_gauss].clone()
    table, ftable = table[:n_gauss].contiguous(), ftable[:n_gauss].contiguous()
    o, d = _rays("reflected" if rays == "reflected" else "primary", device,
                 n_rays)
    if rays == "mixed":
        o = o.clone()
        o[tile::2 * tile] += torch.tensor([0.0, 1e-3, 0.0], device=device)
    if rays == "ulp":
        o = o.clone()
        y = o[tile::2 * tile, 1]
        o[tile::2 * tile, 1] = torch.nextafter(y, torch.full_like(y, np.inf))
    if special == "ties":
        gpack[:, 1::2] = gpack[:, 0::2]
        half = n_gauss // 2
        gpack[:, half:2 * half] = gpack[:, :half]
    if special == "invalid_cluster":
        gpack[ROW_VALID, 7 * cluster:8 * cluster] = 0.0
    if special == "thin":
        _make_thin(gpack, o, d)
    gpack = gpack.contiguous()
    near = 0.0 if rays == "reflected" else 0.05
    T, nc = n_rays // tile, n_gauss // cluster
    if lists == "select":
        cands, cnear, _n, _o, _t = culling.select_candidates(
            o, d, bounds, near, FAR, tile=tile, max_clusters=24)
    elif lists == "hand":
        rng = np.random.default_rng(9)
        lst = rng.integers(0, nc, size=(T, 20))
        lst[:, 3] = 7
        lst[rng.uniform(size=(T, 20)) < 0.15] = -1
        cands = torch.tensor(lst, dtype=torch.int32, device=device)
        cnear = torch.tensor(np.sort(rng.uniform(0.0, 8.0, size=(T, 20)),
                                     axis=1), dtype=torch.float32,
                             device=device)
    else:
        cands = torch.arange(nc, dtype=torch.int32, device=device).expand(
            T, nc).contiguous()
        cnear = torch.full((T, nc), -np.inf, device=device)
    return o, d, gpack, table, ftable, cands, cnear, near


# The boundary-tie case: an exact depth tie at the K-th slot that a later,
# nearer hit evicts.  One tile of 256 rays, each through a line of round
# Gaussians on the view axis.  Cluster 0 holds K hits; the three deepest
# stand at lanes p1 < p3 < p2 (deepest, third, second), every other below
# A.  Cluster 1 holds, in lane order, A, a nearer C, and B: a copy of A's
# geometry (so the two tie bit for bit on every ray) with other attributes.
# Cluster 2 holds D, nearer than A.  The walk in Gaussian order puts A, C
# and B in the slots of the deepest, second and third of cluster 0, that is
# in lane order p1, p2, p3 (A before B); the drain, which filled cluster 0's
# hits in depth order, puts C, A and B in those of the deepest, second and
# third (B before A).  D replaces the first slot holding A's depth: B in the
# drain, which keeps A.
TIE_LANES = dict(p1=3, p3=8, p2=12, A=1, C=6, B=9, D=2)
TIE_RAYS = 256


def boundary_tie_case(K=16, cluster=128, shared=True, seed=0):
    """The boundary-tie case as numpy arrays: rays_o, rays_d [256, 3];
    gpack [32, 3 * cluster]; table [N, 16] (the attribute table of gpack's
    rows); ftable [N, 32] (a frame table of random values); candidates and
    cand_near [1, 3] (clusters 0, 1, 2 at near 0); and the ids of A and B.
    shared: every ray starts at the origin (a primary pass), else origins
    a little apart."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda import layout as L

    rng = np.random.default_rng(seed)
    lanes, C = TIE_LANES, cluster
    N = 3 * C
    uv = rng.uniform(-0.02, 0.02, size=(TIE_RAYS, 2))
    d = np.concatenate([uv, np.ones((TIE_RAYS, 1))], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros((TIE_RAYS, 3), np.float32)
    if not shared:
        o += rng.uniform(-1e-3, 1e-3, size=o.shape).astype(np.float32)
    depth = np.zeros(N)
    deep = {lanes["p1"]: 10.0, lanes["p2"]: 9.5, lanes["p3"]: 9.0}
    rest = [k for k in range(K) if k not in deep]
    depth[rest] = rng.permutation(1.0 + 5.0 * np.arange(K - 3) / (K - 3))
    for k, z in deep.items():
        depth[k] = z
    a, b = C + lanes["A"], C + lanes["B"]
    depth[a] = depth[b] = 8.0
    depth[C + lanes["C"]] = 7.5
    depth[2 * C + lanes["D"]] = 6.75
    on = depth > 0.0
    gpack = np.zeros((L.N_ROWS, N), np.float32)
    gpack[L.ROW_MEAN + 2] = depth
    for i in range(3):
        gpack[L.ROW_ROT + 4 * i] = 1.0          # identity rotation
    gpack[L.ROW_INV:L.ROW_INV + 3] = 2.0        # radius 0.5
    gpack[L.ROW_OPACITY] = 0.05
    gpack[L.ROW_SF2] = 1.0
    gpack[L.ROW_NRM + 2] = -1.0
    gpack[L.ROW_NLEN] = 1.0
    gpack[L.ROW_VALID] = 1.0
    for row in (L.ROW_RGB, L.ROW_F0):
        gpack[row:row + 3] = rng.uniform(size=(3, N))
    gpack[L.ROW_ROUGH] = rng.uniform(size=N)
    gpack[L.ROW_RGB:L.ROW_RGB + 3, a] = (1.0, 0.0, 0.0)
    gpack[L.ROW_RGB:L.ROW_RGB + 3, b] = (0.0, 0.0, 1.0)
    gpack[:, ~on] = 0.0
    table = np.zeros((N, L.TABLE_A), np.float32)
    table[:, :L.NUM_ATTR] = gpack[list(L.ATTR_ROWS)].T
    ftable = rng.normal(size=(N, 32)).astype(np.float32)
    return dict(rays_o=o, rays_d=d, gpack=gpack, table=table, ftable=ftable,
                candidates=np.array([[0, 1, 2]], np.int32),
                cand_near=np.zeros((1, 3), np.float32), a=a, b=b)


def tie_stress_inputs(device, rays, seed):
    """Exact depth ties everywhere: the room's first 2048 Gaussians with the
    geometry of half of them copied onto other random columns, clusters of
    64 listed for each 128-ray tile in a random order at near -INF (so
    later clusters keep evicting between tied hits), 1024 primary or
    reflected rays.  Returns (rays_o, rays_d, gpack, table, ftable,
    candidates, cand_near, call kwargs but max_hits)."""
    rng = np.random.default_rng(seed)
    n_gauss, cluster, tile = 2048, 64, 128
    gpack, _b, table, ftable = _tables(device, 256)
    gpack = gpack[:, :n_gauss].clone()
    src = rng.integers(0, n_gauss, size=n_gauss // 2)
    dst = rng.integers(0, n_gauss, size=n_gauss // 2)
    gpack[:ROW_VALID + 1, dst] = gpack[:ROW_VALID + 1, src]
    o, d = _rays(rays, device, 1024)
    T, nc = 1024 // tile, n_gauss // cluster
    cands = torch.tensor(np.stack([rng.permutation(nc) for _ in range(T)]),
                         dtype=torch.int32, device=device)
    cnear = torch.full((T, nc), -np.inf, device=device)
    return (o, d, gpack.contiguous(), table[:n_gauss].contiguous(),
            ftable[:n_gauss].contiguous(), cands, cnear,
            dict(cluster=cluster, tile=tile, transmittance_threshold=0.0))


def boundary_tie_tensors(device, **kw):
    """boundary_tie_case as tensors on `device` (rays_o, rays_d, gpack,
    table, ftable, candidates, cand_near), and the ids of A and B."""
    case = boundary_tie_case(**kw)
    names = ("rays_o", "rays_d", "gpack", "table", "ftable", "candidates",
             "cand_near")
    return (tuple(torch.tensor(case[n], device=device) for n in names),
            case["a"], case["b"])


def mixed_alive(n_rays, tile, device):
    """Every third ray dead, and the last block wholly dead."""
    alive = (torch.arange(n_rays, device=device) % 3) != 0
    alive[-tile:] = False
    return alive


# the exit tiles: where the heavy cluster stands in each tile's list of 8
# (None: light clusters only), and whether every fourth ray of the tile is
# dead; then a tile of dead rays
EXIT_TILES = ([(p, False) for p in range(8)] + [(None, False), (2, True)])


def exit_tile_inputs(device, tile=64):
    """Tiles of `tile` copies of one primary ray over lists of 8 clusters of
    256 (EXIT_TILES): clusters the ray misses (light) and, at one position,
    a cluster that saturates it alone (heavy); near distances -INF, and a
    threshold of half the heavy cluster's log T, so that every tile can stop
    only on saturation, at each position in turn.  Returns (rays_o, rays_d,
    gpack, table, ftable, candidates, cand_near, alive, threshold)."""
    gpack, _b, table, ftable = _tables(device, 256)
    C = 256
    nc = gpack.shape[1] // C
    o, d = _rays("primary", device, 1280)
    ray = 16 * 40 + 20                           # near the frame's centre
    oo, dd = _one_ray_tiles(o, d, [ray] * nc, C)
    alone = trace_hits_reference(
        oo, dd, gpack, torch.arange(nc, dtype=torch.int32,
                                    device=device)[:, None],
        torch.full((nc, 1), -np.inf, device=device), 0.05, FAR, 3.0, 0.0,
        0.1, 0.9, transmittance_threshold=0.0, max_hits=16, cluster=C,
        tile=C)
    log_c = alone[5].view(nc, C)[:, 0]
    n_valid = gpack[ROW_VALID].view(nc, C).sum(dim=1)
    heavy = int(torch.argmin(log_c))
    light = [c for c in range(nc)
             if log_c[c].item() == 0.0 and n_valid[c].item() > 0]
    assert log_c[heavy].item() < -0.5 and light
    lists = [[heavy if i == pos else light[0] for i in range(8)]
             for pos, _dead in EXIT_TILES] + [[heavy] * 8]
    n_tiles = len(lists)
    oo, dd = _one_ray_tiles(o, d, [ray] * n_tiles, tile)
    alive = torch.ones(n_tiles * tile, dtype=torch.bool, device=device)
    for i, (_pos, dead) in enumerate(EXIT_TILES):
        if dead:
            alive[i * tile:(i + 1) * tile:4] = False
    alive[-tile:] = False
    cands = torch.tensor(lists, dtype=torch.int32, device=device)
    cnear = torch.full(cands.shape, -np.inf, device=device)
    thr = float(np.exp(log_c[heavy].item() / 2))
    return oo, dd, gpack, table, ftable, cands, cnear, alive, thr


def exit_tile_chunks(exit_mode, check_every):
    """The processed clusters each exit tile counts (all hold valid
    Gaussians): a tile stops at the first vote after its heavy cluster, and
    in exit mode 0 a dead ray never counts as done."""
    out = []
    for pos, dead in EXIT_TILES:
        if pos is None or (dead and exit_mode == 0):
            out.append(8)
        else:
            out.append(min(8, -(-(pos + 1) // check_every) * check_every))
    return out + [0]

def test_trace_hits_wrapper_checks_inputs(cuda):
    gpack, bounds = _gpack(cuda, 256)
    o, d = _rays("primary", cuda, 1280)
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, 0.05, FAR, tile=256, max_clusters=8)
    args = (o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    with pytest.raises(ValueError, match="max_hits"):
        trace_hits(*args, max_hits=24)
    with pytest.raises(ValueError, match="tile"):
        trace_hits(o[:1000], d[:1000], *args[2:], max_hits=16)
    with pytest.raises(ValueError, match="candidates"):
        trace_hits(*args[:3], cands[:, :4].contiguous().to(torch.int64),
                   *args[4:], max_hits=16)


# (W, H, frame kwargs): culled in linear order with a padded last tile, and
# the brute fallback
FRAMES = {
    "culled_linear_padded": (40, 32, dict(max_hits=32, tile=512,
                                          max_clusters=16)),
    "brute_fallback": (36, 30, dict(max_hits=16, tile=512)),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_cuda_frame_equals_cpu_frame(frame, cuda):
    W, H, kw = FRAMES[frame]
    eye, c2w = room_camera()
    samples = rt.draw_tile_samples(torch.Generator().manual_seed(2), W, H,
                                   kw["tile"], 3)
    frames = {}
    for dev in (cuda, torch.device("cpu")):
        cam = rt.CameraParams(origin=torch.tensor(eye, device=dev),
                              c2w=torch.tensor(c2w, device=dev), fov_y=0.9,
                              znear=0.05, zfar=FAR)
        before = trace_hits.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            frames[dev.type] = dispatch_render_frame(
                _scene(dev), cam, rt.RenderSettings(), None, W, H,
                num_bounces=2, samples=rt.TileSamples(
                    samples.jitter.to(dev), samples.us.to(dev)), **kw)
        if dev.type == "cuda":
            assert trace_hits.launches == before + 3
    (sa, fa), (sb, fb) = frames["cuda"], frames["cpu"]
    for f, a, b in zip(rt.StepOutputs._fields + ("final",), (*sa, fa),
                       (*sb, fb)):
        assert torch.isfinite(a).all(), f
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0, msg=f)
    assert fb.mean() > 0.0


def test_cuda_nonfused_step_equals_cpu_step(cuda):
    W = H = 32
    samples = rt.draw_tile_samples(torch.Generator().manual_seed(4), W, H,
                                   512, 3)
    eye, c2w = room_camera()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = _scene(dev, 2048)
        cam = rt.CameraParams(origin=torch.tensor(eye, device=dev),
                              c2w=torch.tensor(c2w, device=dev), fov_y=0.9,
                              znear=0.05, zfar=FAR)
        rng = torch.Generator().manual_seed(5)
        R = W * H
        targets = rt.RayTargets(*(
            torch.rand(shape, generator=rng).to(dev)
            for shape in ((R, 3), (R, 3), (R,), (R, 3), (R,), (R, 3))))
        out[dev.type] = tr.train_step(
            tr.init_train_state(scene), cam, targets, rt.RenderSettings(),
            tr.lr_tree(tr.Config(), 1, 1.0),
            dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                 apply_grads=1.0), None, W, H, num_bounces=2, max_hits=16,
            chunk=2048, tile=512, use_pallas=True, use_culling=False,
            samples=rt.TileSamples(samples.jitter.to(dev),
                                   samples.us.to(dev)))
    (sa, ma), (sb, mb) = out["cuda"], out["cpu"]
    for tree in ("scene", "mu", "nu"):
        for f in tr.PARAM_FIELDS:
            a = getattr(getattr(sa, tree), f)
            torch.testing.assert_close(a.cpu(), getattr(getattr(sb, tree), f),
                                       rtol=0, atol=0, msg=f"{tree}.{f}")
    torch.testing.assert_close(sa.total_weight.cpu(), sb.total_weight,
                               rtol=0, atol=0)
    for k in ma:
        assert ma[k].item() == mb[k].item(), k
    assert (sb.total_weight > 0).any()
