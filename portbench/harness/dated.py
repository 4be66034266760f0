"""What every request family shares: the processed models of a mix's dates,
their sampled columns, and the reference's pass over the same raw fields.

A family's ``Scene`` subclasses :class:`DatedScene`, runs its requests into
``self.kept`` (one record a request, with ``k`` and ``date``), and gives the
reference's answers to those records in :meth:`DatedScene.answers`.
"""

import datetime as dt

import numpy as np
import torch

from portbench.harness import fields, scenes, system
from portbench.reference import hrrr as ref

MODEL_FIELDS = ('wet', 'hydro', 'wet_total', 'hydro_total')
FIRST_DATE = dt.datetime(2021, 7, 1, 12, 0, 0)


class DatedScene:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.traffic, self.seed = traffic, int(seed)
        self.device = torch.device(device)
        self.grid = cfg['grid']
        self.ladder = np.asarray(cfg['ladder_m'], dtype=np.float64)
        self.k = cfg['refractivity']
        self.dates = [FIRST_DATE + dt.timedelta(days=d) for d in range(traffic['dates'])]
        self.models, self.model_kept, self.kept = [], [], []
        self.window = (0, self.grid['ny'], 0, self.grid['nx'])

    def make_models(self, wm_dir: str, ll_bounds=None) -> None:
        """Each date's fields from the seed, cut as HRRR's fetcher cuts them
        for ``ll_bounds`` (when given), processed by the port."""
        for d, when in enumerate(self.dates):
            raw = fields.raw_fields(self.grid, self.seed, d, self.device)
            if ll_bounds is not None:
                self.window = fields.fetcher_cut(ll_bounds, raw['lat'], raw['lon'])
                raw = fields.cut(raw, self.window)
            self.models.append(system.processed_model(raw, self.grid['crs_cf'], when,
                                                      self.device, wm_dir, ll_bounds))
            del raw

    def _columns(self, d: int):
        ny, nx = self.window[1] - self.window[0], self.window[3] - self.window[2]
        return scenes.column_sample(self.seed, d, ny, nx, self.traffic['model_columns'])

    def keep_models(self) -> None:
        """Copy the sampled columns of each processed model to the host."""
        for d, ds in enumerate(self.models):
            iy, ix = self._columns(d)
            dev = torch.as_tensor(ds['wet'].data).device
            sel = (slice(None), torch.as_tensor(iy, device=dev), torch.as_tensor(ix, device=dev))
            self.model_kept.append(dict(date=d, iy=iy + self.window[0], ix=ix + self.window[2],
                                        **{n: torch.as_tensor(ds[n].data)[sel].double().cpu()
                                           .numpy() for n in MODEL_FIELDS}))

    def pending_models(self) -> None:
        for d in range(len(self.dates)):
            iy, ix = self._columns(d)
            self.model_kept.append(dict(date=d, iy=iy + self.window[0], ix=ix + self.window[2]))

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.models.clear()

    def reference(self, store=None) -> tuple:
        """({request k: answers}, {date: model columns}) by the reference, from
        the same raw fields made again from the seed (``store``: the
        control's storage precision)."""
        answers, columns = {}, {}
        for d in range(len(self.dates)):
            raw = fields.raw_fields(self.grid, self.seed, d, self.device)
            nz = raw['t'].shape[0]

            def cols(sel, raw=raw):
                out = {n: raw[n][(slice(None), *sel)].reshape(nz, -1)
                       for n in ('t', 'q', 'pres', 'z')}
                out['lat'] = raw['lat'][sel].reshape(-1)
                return ref.process_columns(out, self.ladder, self.k, store)

            for rec in self.model_kept:
                if rec['date'] == d:
                    p = cols((torch.as_tensor(rec['iy'], device=self.device),
                              torch.as_tensor(rec['ix'], device=self.device)))
                    columns[d] = {n: p[n].cpu().numpy() for n in MODEL_FIELDS}
            grid = ref.Grid(raw['xs'], raw['ys'], self.ladder,
                            ref.LambertConformal(self.grid['crs_cf']))
            answers.update(self.answers(d, grid, cols))
            del raw
        return answers, columns

    def answers(self, d: int, grid: ref.Grid, cols) -> dict:
        """The reference's answers to the kept requests on date ``d``;
        ``cols(index)`` processes the model columns the index selects."""
        raise NotImplementedError

    def fill_from(self, answers: dict, columns: dict) -> None:
        """Put reference results in the program's place (the control)."""
        for rec in self.kept:
            rec.update(answers[rec['k']])
        for rec in self.model_kept:
            rec.update(columns[rec['date']])


def gaps(scene: DatedScene, answers: dict, columns: dict) -> tuple:
    """(largest wet gap, largest hydrostatic gap, largest relative gap over
    the model columns, values finite on one side only)."""
    gap = {'wet': 0.0, 'hydro': 0.0}
    nan_mismatch = 0
    for rec in scene.kept:
        for name in gap:
            got, want = np.asarray(rec[name]), answers[rec['k']][name]
            both = np.isfinite(got) & np.isfinite(want)
            nan_mismatch += int(np.sum(np.isfinite(got) != np.isfinite(want)))
            if both.any():
                gap[name] = max(gap[name], float(np.max(np.abs(got[both] - want[both]))))
    rel = 0.0
    for rec in scene.model_kept:
        for name in MODEL_FIELDS:
            got, want = np.asarray(rec[name]), columns[rec['date']][name]
            nan_mismatch += int(np.sum(np.isfinite(got) != np.isfinite(want)))
            ok = np.isfinite(got) & np.isfinite(want) & (want != 0)
            if ok.any():
                rel = max(rel, float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]))))
            nan_mismatch += int(np.sum((want == 0) & (got != 0)))
    return gap['wet'], gap['hydro'], rel, nan_mismatch
