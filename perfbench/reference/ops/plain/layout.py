"""Data layouts shared by the render kernel, its plain version and callers.

gpack: the transposed per-Gaussian table [N_ROWS, N] f32 (twin of the JAX
ops/pallas/trace_kernel.py pack_frames) - geometry in rows 0-21, shading
attributes in rows 22-28.  The kernel reads a cluster's rows 0-21 into
shared memory and the attribute rows of its K kept hits from device memory.

Output lanes of the [R, OUT_LANES] composite block (twin of the JAX
ops/pallas/render_kernel.py OUT_*).  The row and lane numbers are also
spelled out in csrc/render_culled.cu; keep the two in step.

Training slots (twin of the JAX ops/pallas/render_kernel.py training
variant): the slots trace returns, per ray, SLOT_BLOCKS blocks of K columns
- t, alpha, id, the 10 shading attributes, then the 24 used columns of the
frame table - depth-sorted, with empty slots t = INF and zeros.  The frame
table ([N, FTABLE_A], pack_frame_table) carries what the backward needs per
hit.  csrc/trace_slots.cu spells out the same block order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..gaussian_kernel import MAX_ALPHA
from ..intersect import GaussianFrames
from ..precision import WIDE, norm, rounded

# gpack row layout ([N_ROWS, N]; a cluster block is [N_ROWS, cluster])
ROW_MEAN = 0        # 3 rows
ROW_ROT = 3         # 9 rows, row-major r00..r22
ROW_INV = 12        # 3 rows
ROW_OPACITY = 15
ROW_SF2 = 16        # scaling_factor^2
ROW_NRM = 17        # 3 rows (raw normal, for the secondary backfacing test)
ROW_NLEN = 20
ROW_VALID = 21
ROW_RGB = 22        # 3 rows (relu-activated diffuse)
ROW_F0 = 25         # 3 rows
ROW_ROUGH = 28
N_ROWS = 32         # padded

INF = 3.0e38        # empty-slot depth / padded-candidate near distance

# output lanes of the [R, OUT_LANES] composite block
OUT_RGB = 0         # 3
OUT_NRM = 3         # 3
OUT_F0 = 6          # 3
OUT_ROUGH = 9
OUT_DEPTH = 10
OUT_TFINAL = 11
OUT_FULLT = 12      # exp of the log-transmittance over the processed chunks
OUT_NUMACC = 13
OUT_TRAV = 14       # valid Gaussians in the processed chunks
OUT_CHUNKS = 15     # processed chunks holding any valid Gaussian
OUT_LANES = 16


def pack_frames(frames: GaussianFrames, attrs=None) -> torch.Tensor:
    """GaussianFrames (+ activated SceneAttributes) -> [N_ROWS, N] f32.

    Shading attributes ride along (zeros when attrs is None)."""
    n = frames.mean.shape[0]
    rot_rows = frames.rot.reshape(n, 9)
    z = torch.zeros((n,), dtype=torch.float32, device=frames.mean.device)
    if attrs is None:
        rgb = f0 = (z, z, z)
        rough = z
    else:
        rgb = (attrs.rgb[:, 0], attrs.rgb[:, 1], attrs.rgb[:, 2])
        f0 = (attrs.f0[:, 0], attrs.f0[:, 1], attrs.f0[:, 2])
        rough = attrs.roughness
    rows = [
        frames.mean[:, 0], frames.mean[:, 1], frames.mean[:, 2],
        *[rot_rows[:, i] for i in range(9)],
        frames.inv_sizes[:, 0], frames.inv_sizes[:, 1], frames.inv_sizes[:, 2],
        frames.opacity,
        frames.sf * frames.sf,
        frames.normal[:, 0], frames.normal[:, 1], frames.normal[:, 2],
        norm(frames.normal),
        frames.valid.to(torch.float32),
        *rgb,
        *f0,
        rough,
        z, z, z,
    ]
    return torch.stack(rows, dim=0)


def unpack_composite(out: torch.Tensor) -> dict:
    """[R, OUT_LANES] -> dict of the composite fields."""
    return dict(
        rgb=out[:, OUT_RGB:OUT_RGB + 3],
        normal=out[:, OUT_NRM:OUT_NRM + 3],
        f0=out[:, OUT_F0:OUT_F0 + 3],
        roughness=out[:, OUT_ROUGH],
        depth=out[:, OUT_DEPTH],
        T_final=out[:, OUT_TFINAL],
        full_T=out[:, OUT_FULLT],
        num_accumulated=out[:, OUT_NUMACC].to(torch.int32),
        num_traversed=out[:, OUT_TRAV].to(torch.int32),
    )


# attribute-table columns ([N, TABLE_A], pack_attr_table) and the order of
# the 10 attribute blocks of a slot
COL_RGB = 0         # 3
COL_NRM = 3         # 3
COL_F0 = 6          # 3
COL_ROUGH = 9
TABLE_A = 16        # padded
NUM_ATTR = 10
# gpack rows of the 10 attributes, in the same order
ATTR_ROWS = (ROW_RGB, ROW_RGB + 1, ROW_RGB + 2, ROW_NRM, ROW_NRM + 1,
             ROW_NRM + 2, ROW_F0, ROW_F0 + 1, ROW_F0 + 2, ROW_ROUGH)

# frame-table columns ([N, FTABLE_A], pack_frame_table)
FCOL_MEAN = 0       # 3
FCOL_ROT = 3        # 9 (row-major)
FCOL_INV = 12       # 3
FCOL_SF = 15
FCOL_OPACITY = 16
FCOL_SCALING = 17   # 3 (activated exp(scale))
FCOL_QUAT = 20      # 4 (raw quaternion)
FTABLE_A = 32       # padded
NUM_FRAME = 24      # frame columns carried per slot

SLOT_T, SLOT_ALPHA, SLOT_ID, SLOT_ATTR = 0, 1, 2, 3
SLOT_FRAME = SLOT_ATTR + NUM_ATTR
SLOT_BLOCKS = SLOT_FRAME + NUM_FRAME     # 37


def pack_attr_table(attrs) -> torch.Tensor:
    """Activated SceneAttributes -> [N, TABLE_A] f32 (rgb, normal, f0,
    roughness, zero padding)."""
    n = attrs.rgb.shape[0]
    z = torch.zeros((n, TABLE_A - NUM_ATTR), dtype=torch.float32,
                    device=attrs.rgb.device)
    return torch.cat([attrs.rgb, attrs.normal, attrs.f0,
                      attrs.roughness[:, None], z], dim=1)


def pack_frame_table(frames: GaussianFrames, scene) -> torch.Tensor:
    """GaussianFrames + the raw scene in the same order -> [N, FTABLE_A]
    f32: what the backward needs per hit."""
    n = frames.mean.shape[0]
    z = torch.zeros((n, FTABLE_A - NUM_FRAME), dtype=torch.float32,
                    device=frames.mean.device)
    return torch.cat([
        frames.mean, frames.rot.reshape(n, 9), frames.inv_sizes,
        frames.sf[:, None], frames.opacity[:, None],
        rounded(torch.exp, scene.scaling), scene.rotation, z], dim=1)


def merge_slots(slots_n: torch.Tensor, acc_n: torch.Tensor,
                slots_f: torch.Tensor, acc_f: torch.Tensor, K_n: int,
                K_f: int):
    """Split-far's near-pass and far-pass slots [R, SLOT_BLOCKS*K_n] /
    [R, SLOT_BLOCKS*K_f] as one [R, SLOT_BLOCKS*(K_n+K_f)] list, each slot
    block the near slots then the far ones, and acc with the first three
    lanes (log-T, traversed, processed clusters) added and the rest the
    near pass's (JAX render_kernel.py:765-781).  Every far hit lies behind
    every near hit (the t-window), and the composite passes over empty
    slots (alpha 0, invalid) wherever they sit, so the concatenation is the
    depth-sorted merge."""
    R = slots_n.shape[0]
    slots = torch.cat([slots_n.reshape(R, SLOT_BLOCKS, K_n),
                       slots_f.reshape(R, SLOT_BLOCKS, K_f)], dim=-1)
    acc = torch.cat([acc_n[:, :3] + acc_f[:, :3], acc_n[:, 3:]], dim=1)
    return slots.reshape(R, SLOT_BLOCKS * (K_n + K_f)), acc


def unpack_slots(slots: torch.Tensor, acc: torch.Tensor, K: int,
                 rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Slots [R, SLOT_BLOCKS*K] + acc [R, 16] -> (RayHits fields, attrs,
    frames), dicts of [R, K, ...] tensors.

    gaussval and local_hit are recomputed from the slot's frame fields:
    gaussval = alpha / (MAX_ALPHA * opacity), local_hit = sf*(lo + t*ld).
    Empty slots get degenerate-safe frame values (identity rotation, unit
    sizes), so the backward's normalisations never see 0/0; their
    gradients are masked regardless."""
    R = slots.shape[0]
    blocks = slots.reshape(R, SLOT_BLOCKS, K)

    def blk(i):
        return blocks[:, i]

    def vec(i, n):
        return blocks[:, i:i + n].permute(0, 2, 1)                # [R, K, n]

    t = blk(SLOT_T)
    valid = t < 1e37
    v1 = valid[..., None]
    a0 = SLOT_ATTR
    attrs = dict(rgb=vec(a0 + COL_RGB, 3), normal=vec(a0 + COL_NRM, 3),
                 f0=vec(a0 + COL_F0, 3), roughness=blk(a0 + COL_ROUGH))
    f0_ = SLOT_FRAME

    def safe(x, default):
        m = v1 if x.ndim == 3 else valid
        return torch.where(m, x, torch.full_like(x, default))

    quat = torch.where(v1, vec(f0_ + FCOL_QUAT, 4),
                       slots.new_tensor([1.0, 0.0, 0.0, 0.0]))
    rot9 = torch.where(v1, vec(f0_ + FCOL_ROT, 9),
                       slots.new_tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1]))
    frames = dict(
        mean=safe(vec(f0_ + FCOL_MEAN, 3), 0.0),
        rot=rot9,
        inv_sizes=safe(vec(f0_ + FCOL_INV, 3), 1.0),
        sf=safe(blk(f0_ + FCOL_SF), 1.0),
        opacity=safe(blk(f0_ + FCOL_OPACITY), 1.0),
        scaling_act=safe(vec(f0_ + FCOL_SCALING, 3), 1.0),
        rotation_raw=quat,
    )
    zero = torch.zeros_like(t)
    ts = torch.where(valid, t, zero)
    alpha = blk(SLOT_ALPHA)
    gaussval = torch.where(
        valid, alpha / torch.clamp(MAX_ALPHA * frames["opacity"], min=1e-30),
        zero)
    rot = rot9.reshape(R, K, 3, 3)
    rel = [rays_o[:, None, j] - frames["mean"][..., j] for j in range(3)]
    d = [rays_d[:, None, j] for j in range(3)]
    inv = frames["inv_sizes"]
    lo = [(rot[..., 0, c] * rel[0] + rot[..., 1, c] * rel[1]
           + rot[..., 2, c] * rel[2]) * inv[..., c] for c in range(3)]
    ld = [(rot[..., 0, c] * d[0] + rot[..., 1, c] * d[1]
           + rot[..., 2, c] * d[2]) * inv[..., c] for c in range(3)]
    sf = frames["sf"]
    local_hit = torch.stack([sf * (lo[c] + ts * ld[c]) for c in range(3)],
                            dim=-1)
    hits = dict(
        ids=torch.where(valid, blk(SLOT_ID), zero).to(torch.int32),
        t=ts,
        alpha=torch.where(valid, alpha, zero),
        gaussval=gaussval,
        local_hit=torch.where(v1, local_hit, torch.zeros_like(local_hit)),
        valid=valid,
        full_T=rounded(torch.exp, acc[:, 0]),
        num_traversed=acc[:, 1].to(torch.int32),
    )
    frames["rot_mat"] = rot
    return hits, attrs, frames


# scan table columns ([N, SCAN_COLS], pack_scan_table)
SCAN_COLS = 32
SCAN_GEOM = 22      # direct table: gpack rows 0..21 as columns (ROW_*)
SCAN_ATTR = 22      # 10 attribute columns, in ATTR_ROWS order, both tables
Q_S = 0             # quadric table: 6 - S00, S11, S22, S01, S02, S12
Q_NQ = 6            # 3 - -(S mu')
Q_C = 9             # mu'^T S mu'
Q_ND = 10           # 3 - M^T nrm
Q_OPACITY = 13
Q_SF2 = 14
Q_NLEN = 15
Q_VALID = 16
PAIR_MATHS = ("direct", "quadric")


class ScanTable(NamedTuple):
    """A frame's scan table and the pair math its layout is for."""

    table: torch.Tensor   # [N, SCAN_COLS] f32
    center: torch.Tensor  # [3] f32: the quadric form's origin (zeros for
                          # the direct table)
    pair_math: str        # "direct" (scan, JAX v6) | "quadric" (scanq, v7)


def pack_scan_table(gpack: torch.Tensor, pair_math: str) -> ScanTable:
    """[N_ROWS, N] gpack -> the frame's ScanTable for `pair_math`.

    Quadric weights (render_kernel_v7.py:94-137): with M[i, j] = inv_i *
    rot[3j + i] the Gaussian's world -> unit-sphere matrix and mu' = mean -
    centre, S = M^T M, q = S mu', c = mu'^T S mu' and M^T nrm.  The centre
    (the valid-mass mean of the means), S, q, c and M^T nrm are computed in
    WIDE with every sum spelled out and rounded once, so the table is the
    same on every device."""
    if pair_math not in PAIR_MATHS:
        raise ValueError(f"pair_math={pair_math!r}: expected one of "
                         f"{PAIR_MATHS}")
    n = gpack.shape[1]
    attrs = gpack[list(ATTR_ROWS)].T
    if pair_math == "direct":
        table = torch.cat([gpack[:SCAN_GEOM].T, attrs], dim=1)
        center = torch.zeros((3,), dtype=torch.float32, device=gpack.device)
        return ScanTable(table.contiguous(), center, pair_math)

    g = gpack.to(WIDE)
    mean = [g[ROW_MEAN + i] for i in range(3)]
    valid = g[ROW_VALID]
    mass = torch.clamp(valid.sum(), min=1.0)
    center = torch.stack([(m * valid).sum() / mass for m in mean]).to(
        torch.float32)
    mu = [mean[i] - center[i].to(WIDE) for i in range(3)]
    # M[i][j] = inv_i * rot[3j + i]
    M = [[g[ROW_INV + i] * g[ROW_ROT + 3 * j + i] for j in range(3)]
         for i in range(3)]

    def col_dot(i, j):  # (M^T M)[i][j]
        return M[0][i] * M[0][j] + M[1][i] * M[1][j] + M[2][i] * M[2][j]

    S = [[col_dot(i, j) for j in range(3)] for i in range(3)]
    q = [S[i][0] * mu[0] + S[i][1] * mu[1] + S[i][2] * mu[2]
         for i in range(3)]
    c = mu[0] * q[0] + mu[1] * q[1] + mu[2] * q[2]
    nrm = [g[ROW_NRM + k] for k in range(3)]
    m_nd = [M[0][i] * nrm[0] + M[1][i] * nrm[1] + M[2][i] * nrm[2]
            for i in range(3)]
    cols = [S[0][0], S[1][1], S[2][2], S[0][1], S[0][2], S[1][2],
            -q[0], -q[1], -q[2], c, *m_nd]
    quad = torch.stack(cols, dim=1).to(torch.float32)
    geom = gpack[[ROW_OPACITY, ROW_SF2, ROW_NLEN, ROW_VALID]].T
    pad = torch.zeros((n, SCAN_ATTR - Q_VALID - 1), dtype=torch.float32,
                      device=gpack.device)
    table = torch.cat([quad, geom, pad, attrs], dim=1)
    return ScanTable(table.contiguous(), center, pair_math)
