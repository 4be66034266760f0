"""Worker of tests/test_torch_parallel.py::test_two_process_group.

    python _torch_dist_worker.py <process_id> <num_processes> <port>

Joins a gloo group through ``parallel.initialize_distributed`` (a no-op
for one process), gathers a batch split over the processes with
``device_get_global``, then runs ``tropo_delay`` zenith and raytraced on a
2-shard CPU mesh of its own (the rays split over every process's shards)
and raytraced once more with the table in z-slabs, and prints one ``DIST``
line each. Imports torch and the port only.
"""

import datetime as dt
import hashlib
import sys

import numpy as np
import torch

from raider_tpu_torch.delay import raytrace, tropo_delay
from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.geometry import BoundingBox, Orbit, Raytracing, Zenith
from raider_tpu_torch.io import Dataset, Variable
from raider_tpu_torch.parallel import device_get_global, get_mesh, initialize_distributed

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_distributed(f'localhost:{port}', nproc, pid, device='cpu')

batch = np.arange(17.0) * 1.5
got = device_get_global(torch.as_tensor(np.array_split(batch, nproc)[pid]))
assert np.array_equal(got, batch), got
print('DIST gather', hashlib.sha256(got.tobytes()).hexdigest(), flush=True)

ys, xs = np.linspace(32.0, 35.0, 13), np.linspace(-120.0, -116.0, 17)
zs = np.concatenate([np.arange(-500.0, 3000.0, 500.0), np.arange(3000.0, 30001.0, 1500.0)])
zz, yy, xx = np.meshgrid(zs, ys, xs, indexing='ij')
wet = 100.0 * np.exp(-zz / 2000.0) * (1 + 0.05 * (yy - 33.5) + 0.03 * (xx + 118))
hydro = 270.0 * np.exp(-zz / 8000.0) * (1 + 0.02 * (yy - 33.5))
ds = Dataset(coords={'x': Variable(('x',), xs), 'y': Variable(('y',), ys),
                     'z': Variable(('z',), zs)},
             variables={'wet': Variable(('z', 'y', 'x'), wet),
                        'hydro': Variable(('z', 'y', 'x'), hydro),
                        'wet_total': Variable(('z', 'y', 'x'), 1e-3 * wet),
                        'hydro_total': Variable(('z', 'y', 'x'), 1e-2 * hydro)})
ds.variables['proj'] = Variable((), np.int64(0), Geographic().to_cf())
t0 = dt.datetime(2020, 1, 30, 13, 52, 45)
tt = np.arange(-600.0, 601.0, 10.0)
w = np.sqrt(3.986004418e14 / 7.071e6**3)
th, inc, lon0 = 0.55 + w * tt, np.deg2rad(98.0), np.deg2rad(-130.0)
x, y, z = np.cos(th), np.sin(th) * np.cos(inc), np.sin(th) * np.sin(inc)
pos = 7.071e6 * np.stack([np.cos(lon0) * x - np.sin(lon0) * y,
                          np.sin(lon0) * x + np.cos(lon0) * y, z], -1)
orbit = Orbit(times=tt, pos=pos, vel=np.gradient(pos, 10.0, axis=0), ref_time=t0)
mesh = get_mesh(devices=('cpu', 'cpu'))


def cube(los, **kw):
    out, _ = tropo_delay(t0, ds, BoundingBox([33.2, 33.8, -118.0, -117.4],
                                             cube_spacing_in_m=8000.0),
                         los, height_levels=[0.0, 1000.0], device='cpu', mesh=mesh, **kw)
    return np.stack([out['wet'].data, out['hydro'].data])


for name, los in (('zenith', Zenith()), ('raytraced', Raytracing(orbit=orbit, time=t0))):
    c = cube(los)
    assert np.isfinite(c).all() and c.shape[2] * c.shape[3] >= 64
    print('DIST', name, hashlib.sha256(c.tobytes()).hexdigest(), flush=True)

raytrace._BRICK_SPECS = ((7, 3, 3, 6, 0),)     # no brick table: a packed mode
c = cube(Raytracing(orbit=orbit, time=t0), zshard=True)
print('DIST zslab', ' '.join(repr(float(v)) for v in c[:, :, ::3, ::3].ravel()), flush=True)
