"""Time zenith delay requests of one or more source trees of the port on
the card, each tree in a process of its own, in the order given (say
parent, change, change, parent):

    python -m raider_tpu_torch.scripts.zenith_timing parent=DIR change=. change=. parent=DIR

Two requests on seeded synthetic processed weather models (geographic, so
``delay.engine._build_cube`` takes its separable contractions):

  * ``phase3``: chip_smoke phase 3's zenith request, a 50 x 400 x 400 model
    over 16-24 N, 1.5-7.5 E and its BBOX at 250 m, 3 heights (1,335 output
    rows);
  * ``conus``: a HRRR-sized 50 x 1059 x 1799 model over 21-53 N, 134-60 W
    and the contiguous US (25-49 N, 124-67 W) at 2 km, 4 heights.

One JSON line per tree and request: the whole ``tropo_delay`` call and the
cube builder alone (``_build_cube`` on the request's output grid), in ms by
the host clock around synchronized calls (median of 5 after a warm-up), and
a digest of the cubes; then, for each request, the largest difference of
each tree's cubes from the first tree's. The card's name and power limit
come first.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 5
CASES = {
    # name: (model (nz, ny, nx), model S N W E, request S N W E, spacing m, heights)
    'phase3': ((50, 400, 400), (16.0, 24.0, 1.5, 7.5), [18.5, 21.5, 3.5, 6.0], 250.0,
               [0.0, 500.0, 1500.0]),
    'conus': ((50, 1059, 1799), (21.0, 53.0, -134.0, -60.0), [25.0, 49.0, -124.0, -67.0], 2000.0,
              [0.0, 500.0, 1500.0, 3000.0]),
}


def model_dataset(shape, snwe, seed=5):
    """A processed-weather Dataset: zenith delay totals that fall off with
    height, with seeded smooth variation in latitude and longitude."""
    from raider_tpu_torch.io import Dataset, Variable

    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    zs = np.linspace(-100.0, 26000.0, nz)
    ys = np.linspace(snwe[0], snwe[1], ny)
    xs = np.linspace(snwe[2], snwe[3], nx)
    ripple = (1.0 + 0.05 * np.sin(np.deg2rad(ys)[:, None] * rng.uniform(20, 40))
              * np.cos(np.deg2rad(xs)[None, :] * rng.uniform(20, 40)))
    hydro = 2.3 * np.exp(-zs / 8000.0)[:, None, None] * ripple
    wet = 0.25 * np.exp(-zs / 2000.0)[:, None, None] * ripple ** 3
    coords = {'x': Variable(('x',), xs), 'y': Variable(('y',), ys), 'z': Variable(('z',), zs)}
    variables = {'wet_total': Variable(('z', 'y', 'x'), wet),
                 'hydro_total': Variable(('z', 'y', 'x'), hydro)}
    return Dataset(coords=coords, variables=variables)


def child(tree: str, label: str, out_dir: str) -> None:
    """Time the requests with the package of ``tree``; one JSON line each."""
    sys.path.insert(0, os.path.abspath(tree))
    import logging

    import torch

    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.geodesy import Geographic
    from raider_tpu_torch.geometry import BoundingBox, Zenith
    from raider_tpu_torch.logger import logger

    logger.setLevel(logging.ERROR)
    assert engine.__file__.startswith(os.path.abspath(tree)), engine.__file__
    when = engine.dt.datetime(2020, 1, 1, 12)
    for name, (shape, snwe, box, spacing, heights) in CASES.items():
        ds_wm = model_dataset(shape, snwe)

        def request():
            ds, _ = engine.tropo_delay(when, ds_wm, BoundingBox(box, cube_spacing_in_m=spacing),
                                       Zenith(), height_levels=heights, device='cuda')
            return ds

        ds = request()
        wm = engine.WeatherCube(ds_wm, 'cuda')
        xpts, ypts = (np.asarray(ds.coords[k].data) for k in ('x', 'y'))
        zpts = np.asarray(heights, dtype=np.float64)

        def build():
            return engine._build_cube(wm, xpts, ypts, zpts, Geographic(),
                                      ('wet_total', 'hydro_total'), torch.float32)

        build()
        times = {'request_ms': [], 'build_ms': []}
        for key, fn in (('request_ms', request), ('build_ms', build)):
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1e3)
        wet, hydro = (np.asarray(ds[k].data) for k in ('wet', 'hydro'))
        np.savez(os.path.join(out_dir, f'{label}_{name}.npz'), wet=wet, hydro=hydro)
        digest = hashlib.sha256(wet.tobytes() + hydro.tobytes()).hexdigest()[:16]
        print(json.dumps(dict(tree=label, case=name, rows=int(ypts.size), cols=int(xpts.size),
                              heights=len(heights), **times,
                              median_request_ms=float(np.median(times['request_ms'])),
                              median_build_ms=float(np.median(times['build_ms'])),
                              sha256=digest)), flush=True)


def main(argv) -> int:
    if argv[:1] == ['--child']:
        child(*argv[1:4])
        return 0
    from raider_tpu_torch.scripts import card

    out_dir = os.path.abspath(os.path.join('build', 'zenith_timing'))
    os.makedirs(out_dir, exist_ok=True)
    print(card(), flush=True)
    runs = [a.split('=', 1) for a in argv]
    for label, tree in runs:
        subprocess.run([sys.executable, os.path.abspath(__file__), '--child', tree, label, out_dir],
                       check=True, timeout=1200)
    first = runs[0][0]
    for name in CASES:
        ref = np.load(os.path.join(out_dir, f'{first}_{name}.npz'))
        for label in dict.fromkeys(label for label, _ in runs[1:]):
            got = np.load(os.path.join(out_dir, f'{label}_{name}.npz'))
            print(json.dumps(dict(case=name, against=first, tree=label, **{
                k: dict(max_abs_diff_m=float(np.nanmax(np.abs(got[k] - ref[k]))),
                        bit_equal=bool(np.array_equal(got[k], ref[k], equal_nan=True)))
                for k in ('wet', 'hydro')})), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
