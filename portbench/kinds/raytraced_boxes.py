"""Raytraced delay cubes over boxes: the request family of the ``ray`` mixes.

Set-up makes each date's processed model (``harness/dated.py``; cut as
HRRR's fetcher cuts it for the frame where the configuration has a
``cut``) and prepares each frame's AOI and LOS as calc-delays does.
Request ``k`` asks ``tropo_delay`` for frame ``k % frames`` on date
``k % dates``, and keeps a seeded sample of its answers and its grid.
"""

import os

import numpy as np
import torch

from portbench.harness import dated, scenes, system
from portbench.reference import hrrr as ref


class Scene(dated.DatedScene):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        super().__init__(cfg, traffic, seed, device)
        self.heights = scenes.heights(traffic['heights_m'])
        cut = cfg.get('cut')
        self.frames = scenes.frames(traffic['frames'], cut and cut['frame_snwe'], self.seed)
        self.orbits, self.aois, self.loses, bounds = [], [], [], []
        for f in self.frames:
            o = scenes.orbit(f[2] + traffic['track_offset_deg'], 0.5 * (f[0] + f[1]),
                             traffic['orbit'])
            aoi, los, b = system.frame_request(f, traffic['cube_spacing_m'],
                                               *scenes.statevectors(o), dated.FIRST_DATE,
                                               traffic['look'])
            self.orbits.append(o)
            self.aois.append(aoi)
            self.loses.append(los)
            bounds.append(b)
        self.pixels = [(aoi.ypts.copy(), aoi.xpts.copy()) for aoi in self.aois]
        self.make_models(os.path.join(workdir, 'no_processed_files'), bounds[0] if cut else None)

    def inputs(self, k: int):
        return k % len(self.frames), k % len(self.dates)

    def request(self, k: int, keep: bool = True) -> int:
        """Run request ``k``; returns the (wet, hydro) pairs it delivered."""
        f, d = self.inputs(k)
        out = system.delays(self.dates[d], self.models[d], self.aois[f], self.loses[f],
                            self.heights, self.device)
        wet, hyd = np.asarray(out['wet'].data), np.asarray(out['hydro'].data)
        if keep:
            coords = {a: np.asarray(out.coords[a].data, dtype=np.float64) for a in 'zyx'}
            grid = self._grid_faults(f, coords)
            if wet.shape != hyd.shape or wet.shape != tuple(coords[a].size for a in 'zyx'):
                # answers that fit no grid: nothing to sample, a grid fault
                h = r = c = np.zeros(0, dtype=int)
                wet = hyd = np.zeros((1, 1, 1))
                grid = 1
            else:
                h, r, c = scenes.answer_sample(self.seed, k, wet.shape,
                                               self.traffic['samples_per_request'])
            self.kept.append(dict(k=k, frame=f, date=d, z=coords['z'][h], lat=coords['y'][r],
                                  lon=coords['x'][c], wet=wet[h, r, c].copy(),
                                  hydro=hyd[h, r, c].copy(), grid=grid))
        return int(np.asarray(out['wet'].data).size)

    def _grid_faults(self, f: int, coords) -> int:
        """1 when the answer's grid is not the one asked for: other heights,
        another spacing, or a grid that leaves part of the frame out."""
        s, n, w, e = self.frames[f]
        sp = self.traffic['cube_spacing_m'] / 1e5
        x, y, z = coords['x'], coords['y'], coords['z']
        ok = (np.array_equal(z, np.asarray(self.heights)) and x.size > 1 and y.size > 1
              and np.allclose(np.diff(x), sp, rtol=0, atol=1e-9)
              and np.allclose(np.diff(y), -sp, rtol=0, atol=1e-9)
              and x.min() <= w and x.max() >= e and y.min() <= s and y.max() >= n)
        return 0 if ok else 1

    def pending(self, n_requests: int) -> None:
        """Records of the first ``n_requests`` requests and of the models with
        their coordinates and no answers (the control fills them)."""
        for k in range(n_requests):
            f, d = self.inputs(k)
            ypts, xpts = self.pixels[f]
            shape = (len(self.heights), ypts.size, xpts.size)
            h, r, c = scenes.answer_sample(self.seed, k, shape, self.traffic['samples_per_request'])
            self.kept.append(dict(k=k, frame=f, date=d, z=np.asarray(self.heights)[h],
                                  lat=ypts[r], lon=xpts[c], grid=0))
        self.pending_models()

    def free(self) -> None:
        super().free()
        self.aois.clear()
        self.loses.clear()

    def answers(self, d: int, grid: ref.Grid, cols) -> dict:
        zref = float(self.ladder[-1]) - 1.0

        def window(y0, y1, x0, x1):
            p = cols((slice(y0, y1), slice(x0, x1)))
            return tuple(p[n].reshape(-1, y1 - y0, x1 - x0) for n in ('wet', 'hydro'))

        out = {}
        for rec in self.kept:
            if rec['date'] != d:
                continue
            wet = np.full(rec['z'].shape, np.nan)
            hyd = np.full(rec['z'].shape, np.nan)
            for ht in np.unique(rec['z']):
                m = rec['z'] == ht
                lat, lon = (torch.as_tensor(rec[a][m], device=self.device) for a in ('lat', 'lon'))
                w, h = ref.ray_delays(lat, lon, float(ht), self.orbits[rec['frame']], grid,
                                      window, zref, self.traffic['reference_points'])
                wet[m], hyd[m] = w.cpu().numpy(), h.cpu().numpy()
            out[rec['k']] = dict(wet=wet, hydro=hyd)
        return out


def compare(scene: Scene, answers: dict, columns: dict) -> dict:
    """The numbers that decide ``correct``: the largest wet and hydrostatic
    gap (m) over the sampled answers, the largest relative gap over the
    sampled model columns, the values finite on one side only, and the
    answers on a grid other than the one asked for."""
    wet, hydro, rel, nan_mismatch = dated.gaps(scene, answers, columns)
    return {'ray_wet_max_m': wet, 'ray_hydro_max_m': hydro, 'model_max_rel': rel,
            'nan_mismatch': nan_mismatch,
            'grid_mismatch': int(sum(rec['grid'] for rec in scene.kept))}
