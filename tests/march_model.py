"""The turbo march's test cases and a numpy model of its CUDA kernel
(``ngp_tpu_torch/ops/kernels/csrc/march_kernels.cu``), and the eval
prepass's test cases, without JAX, so that the CPU tests
(``test_torch_march_fused.py``, ``test_torch_occupancy.py``) and the card
tests (``test_torch_cuda_kernels.py``) share them.

The model marches each ray as the kernel's warp does: the lattice in
rounds of 32 probes in march order, the coarse survivors compacted in
ballot order up to K2 while their count runs on to the end of the
lattice, crossings found against the previous candidate's cell, fine
bits read from each candidate's own coarse cell (no slot table), the
transmittance proxy summed front to back in double, and the first S
fine survivors taken by a second pass. Every float is rounded as the
kernel rounds it: f32 numpy operations, one rounding each.
"""

import math

import numpy as np

from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.ops.lattice import dt_bounds, lattice_probes

F32 = np.float32
CONFIG = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
              grid_size=16, turbo=True, coarse_candidates=32, crossing_slots=8,
              compact_mean_samples=6)

# name -> (config changes, occupied share of the grid, rays, noise, t_range)
CASES = {
    "default": (dict(), 0.15, "box", False, False),
    "wide budgets": (dict(coarse_candidates=64, crossing_slots=64, max_samples_per_ray=32), 0.15,
                     "box", False, False),
    "dt_gamma, bound 2": (dict(dt_gamma=1 / 128, bound=2.0), 0.15, "box", False, False),
    "lattice span": (dict(lattice_span=1.5), 0.15, "box", False, False),
    "dt_gamma, noise": (dict(dt_gamma=1 / 128), 0.15, "box", True, False),
    "t_range, proxy": (dict(t_proxy_thresh=0.5, density_scale=10.0), 0.4, "box", False, True),
    "more than K2 coarse survivors": (dict(coarse_candidates=16), 0.9, "box", False, False),
    "more than U crossings": (dict(crossing_slots=2), 0.3, "box", False, False),
    "misses and starts inside": (dict(), 0.15, "edge", False, False),
    "bound 2, noise": (dict(bound=2.0), 0.15, "box", True, False),
}


# the eval prepass: name -> (config changes, occupied share of the grid,
# rays, box override); bound 1, 2 and 4 have one, two and three cascades
PREPASS_CASES = {
    "default": (dict(), 0.02, "box", None),
    "bound 2, dt_gamma": (dict(bound=2.0, dt_gamma=1 / 128), 0.02, "box", None),
    "bound 2": (dict(bound=2.0), 0.02, "box", None),
    "bound 4": (dict(bound=4.0), 0.02, "box", None),
    "bound 4, dt_gamma": (dict(bound=4.0, dt_gamma=1 / 128), 0.02, "box", None),
    "dt_gamma": (dict(dt_gamma=1 / 128), 0.02, "box", None),
    "tight box": (dict(), 0.05, "box", (-0.45, -0.4, -0.6, 0.35, 0.5, 0.3)),
    "tight box, bound 2": (dict(bound=2.0), 0.05, "box", (-0.9, -1.2, -0.7, 1.1, 0.6, 1.3)),
    "lattice span": (dict(lattice_span=1.5), 0.05, "box", None),
    "lattice span, bound 2": (dict(bound=2.0, lattice_span=2.5, dt_gamma=1 / 128), 0.05, "box",
                              None),
    "misses and starts inside": (dict(), 0.05, "edge", None),
    "misses and starts inside, bound 4": (dict(bound=4.0, dt_gamma=1 / 128), 0.05, "edge", None),
}


def config(kw):
    return {**CONFIG, **kw}


def grids(cfg: RenderConfig, seed=1, frac=0.2):
    """Random density and occupancy grids [CAS, H, H, H] (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.cascades,) + (cfg.grid_size,) * 3
    dens = rng.exponential(20.0, size=shape).astype(np.float32)
    dens[rng.random(shape) < 0.05] = -1.0
    occ = (rng.random(shape) < frac) & (dens > 0)
    return occ, dens


def rays(kind, n=96, seed=0, bound=1.0):
    """[n, 3] origins and unit directions: "box" from behind the box
    towards it; "edge" adds rays that start inside the box, rays that
    point away from it and rays parallel to its faces (direction
    components exactly 0) outside its slabs."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32)
    ro[:, 2] = -2.2 * bound
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.6
    if kind == "edge":
        q = n // 4
        ro[:q] = rng.uniform(-0.8 * bound, 0.8 * bound, size=(q, 3))
        d[:q] = rng.normal(size=(q, 3))
        ro[q:2 * q, 2] = 2.2 * bound
        ro[2 * q:3 * q] = [1.5 * bound, 0.0, -2.2 * bound]
        d[2 * q:3 * q] = [0.0, 0.0, 1.0]
        d[2 * q:3 * q, 1] = np.linspace(-0.3, 0.3, q)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro.astype(np.float32), d.astype(np.float32)


def t_ranges(n, seed=4):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(1.2, 1.8, size=n).astype(np.float32)
    return np.stack([lo, lo + rng.uniform(0.5, 1.5, size=n).astype(np.float32)], axis=-1)


def _frexp_exponent(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        return (np.floor(np.log2(np.maximum(x, F32(1e-30)))) + F32(1)).astype(np.int32)


def _cells(cfg, o, d, t, dt):
    """(flat coarse cell, fine cell within it) of the probes t [32]."""
    H, cas = cfg.grid_size, cfg.cascades
    Hc = H // 4
    b = F32(cfg.bound)
    x = np.clip(o[None, :] + d[None, :] * t[:, None], -b, b)
    lvl = np.maximum(np.clip(_frexp_exponent(np.abs(x).max(axis=1)), 0, cas - 1),
                     np.clip(_frexp_exponent(dt * F32(H) * F32(0.5)), 0, cas - 1))
    mb = np.minimum(F32(2.0) ** lvl.astype(np.float32), b)
    n = np.clip((F32(0.5) * (x / mb[:, None] + F32(1)) * F32(H)).astype(np.int32), 0, H - 1)
    c, f = n // 4, n % 4
    flat = ((lvl * Hc + c[:, 0]) * Hc + c[:, 1]) * Hc + c[:, 2]
    return flat, (f[:, 0] * 4 + f[:, 1]) * 4 + f[:, 2]


def march_model(ro, rd, coarse_payload, fine_payload, cfg: RenderConfig, S, K2, U, aabb=None,
                t_range=None, noise=None):
    """The kernel's march on numpy inputs: the outputs of ``march_turbo``
    (nears, fars, ts, deltas, mask, n_total, n_dropped) and, per ray,
    the counts it ran on (n_coarse, n_cross) and the proxy's closest
    approach to its threshold, min |sum - thr| / thr over the fine
    survivors (inf without the proxy)."""
    N = ro.shape[0]
    dt_min, dt_max = (F32(v) for v in dt_bounds(cfg))
    gamma = F32(cfg.dt_gamma)
    K = lattice_probes(cfg)
    occ = coarse_payload.reshape(-1).astype(np.int64)
    box = np.asarray(cfg.aabb if aabb is None else aabb, np.float32)
    proxy = cfg.t_proxy_thresh is not None and fine_payload.shape[1] >= 18
    thr = F32(-math.log(cfg.t_proxy_thresh)) if proxy else F32(0)
    lanes = np.arange(32)
    out = {k: np.zeros(N, np.float32) for k in ("nears", "fars", "n_dropped", "approach")}
    out.update(ts=np.zeros((N, S), np.float32), deltas=np.zeros((N, S), np.float32),
               mask=np.zeros((N, S), bool), n_total=np.zeros(N, np.int64),
               n_coarse=np.zeros(N, np.int64), n_cross=np.zeros(N, np.int64))
    out["approach"][:] = np.inf

    def dt_of(t):
        with np.errstate(invalid="ignore"):
            return np.clip(t * gamma, dt_min, dt_max)

    for r in range(N):
        o, d = ro[r], rd[r]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = F32(1) / d
            lo, hi = (box[:3] - o) * inv, (box[3:] - o) * inv
        near, far = np.max(np.minimum(lo, hi)), np.min(np.maximum(lo, hi))
        miss = near > far
        near = np.maximum(near, F32(cfg.min_near))
        if miss:
            near = far = F32(1e10)
        if t_range is not None:
            near, far = np.maximum(near, t_range[r, 0]), np.minimum(far, t_range[r, 1])
        out["nears"][r], out["fars"][r] = near, far
        hit = far > near
        far_c = far if hit else near
        t0 = near if noise is None else near + dt_of(near) * noise[r]
        n_coarse = n_cross = n_tested = n_pass = n_total = 0
        carry = 0
        cum = 0.0
        t_round = t0
        for base in range(0, K if hit else 0, 32):
            k = base + lanes
            if gamma == 0:
                t = t0 + k.astype(np.float32) * dt_min
                dt = np.full(32, dt_min)
            else:
                t = np.empty(32, np.float32)
                for j in range(32):
                    t[j] = t_round
                    t_round = t_round + dt_of(t_round)
                dt = dt_of(t)
            if not t[0] < far_c:
                break
            live = (k < K) & (t < far_c)
            flat, bit6 = _cells(cfg, o, d, t, dt)
            byte = flat >> 3
            inside = (flat >= 0) & (byte < occ.size)
            bits = (occ[np.clip(byte, 0, occ.size - 1)] >> (flat & 7)) & 1
            valid_c = live & inside & (bits > 0)
            # ballot order: a survivor's index is the count of survivors below it
            cand = n_coarse + np.cumsum(valid_c) - valid_c
            full = n_coarse >= K2
            n_coarse += int(valid_c.sum())
            if full:
                continue
            is_cand = valid_c & (cand < K2)
            change = np.zeros(32, bool)
            prev = carry
            for j in np.flatnonzero(is_cand):
                change[j] = cand[j] == 0 or flat[j] != prev
                prev = flat[j]
            carry = prev
            slot = n_cross + np.cumsum(change) - 1
            n_cross += int(change.sum())
            in_budget = is_cand & (slot < U)
            n_tested += int(in_budget.sum())
            # the fine bits of each candidate's own coarse cell
            rows = fine_payload[np.where(in_budget, flat, 0)]
            word = np.take_along_axis(rows, (bit6 >> 5)[:, None], axis=1)[:, 0]
            valid_f = in_budget & (((word >> (bit6 & 31)) & 1) > 0)
            n_pass += int(valid_f.sum())
            if proxy:
                cw = np.take_along_axis(rows, (2 + (bit6 >> 2))[:, None], axis=1)[:, 0]
                code = ((cw >> ((bit6 & 3) * 8)) & 0xFF).astype(np.float32)
                dens = np.where(code > 0, np.exp2(code / F32(8) - F32(16)), F32(0))
                contrib = np.where(valid_f, dens * F32(cfg.density_scale) * dt, F32(0))
                alive = np.ones(32, bool)
                for j in range(32):
                    cum += float(contrib[j])
                    ex = F32(cum) - contrib[j]
                    alive[j] = ex < thr
                    if valid_f[j]:
                        out["approach"][r] = min(out["approach"][r], abs(ex - thr) / thr)
                valid_f &= alive
            s = n_total + np.cumsum(valid_f) - valid_f
            take = valid_f & (s < S)
            out["ts"][r, s[take]] = t[take]
            out["deltas"][r, s[take]] = dt[take]
            out["mask"][r, s[take]] = True
            n_total += int(valid_f.sum())
        kept = min(n_coarse, K2)
        untested = (n_coarse - kept) + (kept - n_tested)
        rate = F32(n_pass) / F32(max(n_tested, 1))
        out["n_dropped"][r] = F32(untested) * rate + F32(max(n_total - S, 0))
        out["n_total"][r], out["n_coarse"][r], out["n_cross"][r] = n_total, n_coarse, n_cross
    return out
