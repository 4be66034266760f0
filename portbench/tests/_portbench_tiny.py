"""A cell shrunk to run on the CPU in seconds: the HRRR grid cut to a
190 x 160 patch of 3 km cells around Kansas with 12 native levels; a
0.3 x 0.4 degree frame at 2 km spacing, three heights, two dates.

``SHAPES`` are the two scenes the request family serves: the frame on the
model's cut (the cell), and two frames drawn from the seed on the whole
model (what a mix of many frames a date sends)."""

from portbench.harness import main

SEED = 2147483700   # larger than 32 signed bits hold
WORKLOAD = 'hrrr_frame.ray'
SHAPES = ['frame_cut', 'drawn_frames']
GRID = {'first_point_lat': 35.0, 'first_point_lon': 258.5, 'ny': 190, 'nx': 160,
        'native_levels': 12}
DRAWN = {'count': 2, 'size_deg': [0.3, 0.4], 'sw_lat': [36.5, 37.5], 'sw_lon': [-99.0, -98.0]}


def overrides(shape: str = 'frame_cut', **traffic) -> dict:
    _, _, cfg, _, _ = main.cell_inputs(WORKLOAD)
    out = {'config': {'grid': dict(cfg['grid'], **GRID)}}
    tr = {'cube_spacing_m': 2000.0, 'heights_m': [-500.0, 0.0, 1500.0], 'samples_per_request': 48,
          'model_columns': 64, 'reference_points': 1024, 'trace_requests': 1, 'dates': 2}
    if shape == 'drawn_frames':
        out['config']['cut'] = None
        tr['frames'] = DRAWN
    else:
        out['config']['cut'] = dict(cfg['cut'], frame_snwe=[37.0, 37.3, -98.8, -98.4])
    tr.update(traffic)
    out['traffic'] = tr
    return out


class StepClock:
    """A clock that moves ``step`` seconds at every reading: a window of
    ``seconds`` then holds the same number of requests on any CPU (three
    readings a request)."""

    def __init__(self, step: float = 0.1):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def run(shape: str, capsys, seconds: float = 1.0, trace: int = 0, workload: str = WORKLOAD, **kw):
    """(exit code, stdout lines, stderr lines) of one tiny run on the CPU."""
    rc = main.main(['--workload', workload, '--seed', str(kw.pop('seed', SEED)),
                    '--seconds', str(seconds), '--trace', str(trace)],
                   device='cpu', overrides=kw.pop('overrides', None) or overrides(shape), **kw)
    cap = capsys.readouterr()
    return rc, cap.out.strip().splitlines(), cap.err.strip().splitlines()
