"""Windowed integrate (kernel B3) against the brick path (kernel B2) on one
coherent ray batch, on the card.

Counterpart of ``scripts/window_ablation.py``: a 50x400x400 cube of random
wet/hydro refractivity, SIDE x SIDE output pixels, each a slant ray at
azimuth 0.7 +- 0.01 rad and zenith 30-40 deg through the 49 level segments
(one look direction, the production shape). Times, by CUDA events, the brick
table's pack, the brick integrate and the windowed integrate (the entry
point; its preparation, tile order and pre-pass; the kernel alone), and
checks the windowed result against the brick one to a relative 1e-5.
Beside the kernel's call time, ``window_kernel_device_ms`` is its device
time in a ``torch.profiler`` trace, ``window_kernel_burst_ms`` its time per
call over bursts of 20 calls back to back, ``cube_pairs_ms`` the
preparation's interleave of the two cubes into (wet, hydro) pairs and
``cube_pads_ms`` two copies of them zero-padded in x as the JAX package
pads them (the layout the kernel took before the interleave), and ``kernels`` names the kernel layer that ran (run as a file, the script uses the package on the path: the way
to time another tree's kernel in the same process layout). Prints one JSON
line:

    python -m raider_tpu_torch.scripts.window_ablation [side]
"""

import json
import sys

import numpy as np
import torch

from raider_tpu_torch.delay.pallas_window import (WX, integrate_rays_windowed, pair_cubes,
                                                  prepare_windowed, window_integrate)
from raider_tpu_torch.delay.raytrace import (_PLAN_BUCKET, _pad_group_plan, build_group_plan,
                                             integrate_rays, pack_cubes)
from raider_tpu_torch import kernels
from raider_tpu_torch.scripts import burst_ms, card, cuda_ms, device_ms
from raider_tpu_torch.utils import require_device

SIDE = 1000
GRID = (50, 400, 400)
TOL = 1e-5


def build_scene(side: int = SIDE, grid=GRID, device='cuda', seed: int = 0, pixels=None,
                y_span=(18.5, 21.5), x_span=(-1.5, 1.5)) -> dict:
    """The ablation's cube, rays and padded plan; rays built on the device.
    ``pixels`` (rows, columns) of the output grid, spread over ``y_span`` and
    ``x_span`` degrees (default: side x side over the ablation's spans)."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid
    zs = -500.0 + 26500.0 * np.linspace(0.0, 1.0, nz) ** 1.4
    ys = np.linspace(16.0, 24.0, ny)
    xs = np.linspace(-4.0, 4.0, nx)
    wet = torch.as_tensor(rng.uniform(0.1, 100.0, (nz, ny, nx)).astype(np.float32), device=dev)
    hydro = torch.as_tensor(rng.uniform(50.0, 300.0, (nz, ny, nx)).astype(np.float32), device=dev)

    heights = zs.copy()
    nyo, nxo = pixels or (side, side)
    n = nyo * nxo
    y0 = torch.as_tensor(np.repeat(np.linspace(*y_span, nyo), nxo), device=dev)
    x0 = torch.as_tensor(np.tile(np.linspace(*x_span, nxo), nyo), device=dev)
    zen_np = np.deg2rad(rng.uniform(30.0, 40.0, n))
    zen = torch.as_tensor(zen_np, device=dev)
    azi = torch.as_tensor(0.7 + rng.uniform(-0.01, 0.01, n), device=dev)
    dzv = np.diff(heights)
    deg_per_m = 1.0 / 111000.0
    dzv_d = torch.as_tensor(dzv, device=dev)[:, None]
    dh = dzv_d * torch.tan(zen)[None, :]
    zero = torch.zeros((1, n), dtype=torch.float64, device=dev)
    bnd_y = (y0 + torch.cat([zero, torch.cumsum(dh * torch.cos(azi) * deg_per_m, 0)])).float()
    bnd_x = (x0 + torch.cat([zero, torch.cumsum(dh * torch.sin(azi) * deg_per_m, 0)])).float()
    bnd_z = torch.as_tensor(heights, dtype=torch.float32, device=dev)[:, None].expand(nz, n).contiguous()
    ray_len = (dzv_d / torch.cos(zen)[None, :]).float()
    d2 = (dh * dh).float()
    re = torch.full((n,), 6371000.0, dtype=torch.float32, device=dev)

    per_level_max = dzv * float((1.0 / np.cos(zen_np)).max())
    hstep_max = dzv * float(np.tan(zen_np).max()) * deg_per_m
    plan = _pad_group_plan(build_group_plan(per_level_max, heights, hstep_max, ys, xs, zs),
                           _PLAN_BUCKET)
    low = torch.stack([bnd_y[:-1], bnd_x[:-1], bnd_z[:-1]], -1)
    high = torch.stack([bnd_y[1:], bnd_x[1:], bnd_z[1:]], -1)
    return dict(wet=wet, hydro=hydro, ys=ys, xs=xs, zs=zs, heights=heights,
                bnd_y=bnd_y, bnd_x=bnd_x, bnd_z=bnd_z, low=low, high=high, d2=d2,
                ray_len=ray_len, re=re, per_level_max=per_level_max, hstep_max=hstep_max,
                plan=plan, shape=(nyo, nxo))


def windowed_args(sc: dict) -> tuple:
    """The positional arguments of ``integrate_rays_windowed`` for a scene."""
    return (sc['wet'], sc['hydro'], sc['ys'], sc['xs'], sc['zs'], sc['low'], sc['high'],
            sc['d2'], sc['ray_len'], sc['re'], sc['plan'], sc['shape'])


def brick(sc: dict, table, mode):
    """Kernel B2's path (``integrate_rays``) on the scene's rays."""
    return integrate_rays(sc['wet'], sc['hydro'], sc['ys'], sc['xs'], sc['zs'],
                          sc['bnd_y'], sc['bnd_x'], sc['bnd_z'], sc['d2'], sc['ray_len'],
                          sc['re'], sc['per_level_max'], packed2d=table, mode=mode,
                          heights=sc['heights'], hstep_max=sc['hstep_max'])


def max_rel(a, b) -> float:
    """max |a - b| / max |b| over the entries finite in both (the JAX script's
    nanmax ratio)."""
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not bool(ok.any()):
        return 0.0
    return float((a[ok] - b[ok]).abs().max() / b[ok].abs().max())


def run(sc: dict, say=print) -> dict:
    """Windowed vs brick on one scene: errors, and on the card the times.
    Raises if the windowed path declines or disagrees with the brick one."""
    dev = sc['wet'].device
    table, mode = pack_cubes(sc['wet'], sc['hydro'], grouped=True)
    w_b, h_b = brick(sc, table, mode)
    w_w, h_w, used = integrate_rays_windowed(*windowed_args(sc), device=dev)
    if not used:
        raise AssertionError('windowed path declined the coherent batch')
    rel = max(max_rel(w_w, w_b), max_rel(h_w, h_b))
    same_nan = bool(torch.equal(torch.isnan(w_w), torch.isnan(w_b))
                    and torch.equal(torch.isnan(h_w), torch.isnan(h_b)))
    plan = sc['plan']
    rec = dict(rays=int(sc['re'].shape[0]), groups=int(plan.anchor.size), G=int(plan.G),
               max_rel=rel, nan_masks_equal=same_nan,
               finite=float((torch.isfinite(w_w) & torch.isfinite(h_w)).float().mean()))
    if dev.type == 'cuda':
        b = prepare_windowed(*windowed_args(sc), device=dev)
        nx = sc['wet'].shape[2]
        nxp = max(-(-nx // 128) * 128, WX)
        pads = lambda: [torch.nn.functional.pad(c, (0, nxp - nx)).contiguous()
                        for c in (sc['wet'], sc['hydro'])]
        rec.update(
            wy=b.wy,
            brick_pack_ms=cuda_ms(lambda: pack_cubes(sc['wet'], sc['hydro'], grouped=True)),
            brick_ms=cuda_ms(lambda: brick(sc, table, mode)),
            window_ms=cuda_ms(lambda: integrate_rays_windowed(*windowed_args(sc), device=dev)),
            window_prepare_ms=cuda_ms(lambda: prepare_windowed(*windowed_args(sc), device=dev)),
            window_kernel_ms=cuda_ms(lambda: window_integrate(b)),
            window_kernel_device_ms=device_ms(lambda: window_integrate(b),
                                              'window_integrate_kernel')[1],
            window_kernel_burst_ms=burst_ms(lambda: window_integrate(b)),
            cube_pairs_ms=cuda_ms(lambda: pair_cubes(sc['wet'], sc['hydro'], dev)),
            cube_pads_ms=cuda_ms(pads),
            kernels=kernels.__file__)
    say(json.dumps(rec))
    if not rel < TOL:
        raise AssertionError(f'windowed kernel mismatch: max-rel {rel} >= {TOL}')
    return rec


def main() -> None:
    side = int(sys.argv[1]) if len(sys.argv) > 1 else SIDE
    dev = require_device('cuda')
    print(json.dumps(dict(card=card(), torch=torch.__version__, cuda=torch.version.cuda)),
          flush=True)
    run(build_scene(side, device=dev), say=lambda s: print(s, flush=True))
    print('WINDOWED KERNEL OK', flush=True)


if __name__ == '__main__':
    main()
