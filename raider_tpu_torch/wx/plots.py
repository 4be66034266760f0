"""Weather-model debug plots: the counterpart of ``raider_tpu/wx/plots.py``.

plot_pqt: vertical p/q/T profile panels; plot_wh: wet/hydro refractivity
slices at 500 m and 15 km. The model's fields (tensors on its device) are
copied to the host; matplotlib is imported inside each function.
"""

import numpy as np

from raider_tpu_torch.io.ncdf import to_numpy


def _host(a, dtype=None) -> np.ndarray:
    """A model field (a tensor on any device, or an array) as a host array."""
    a = to_numpy(a)
    return a.astype(dtype) if dtype is not None else a


def _slice_at_height(cube_yxz: np.ndarray, zs: np.ndarray, z: float) -> np.ndarray:
    """Linear z-interpolation of a (y, x, z) cube to one height."""
    n = zs.size
    i = int(np.clip(np.searchsorted(zs, z, side='right') - 1, 0, n - 2))
    f = (z - zs[i]) / (zs[i + 1] - zs[i])
    f = float(np.clip(f, 0.0, 1.0))
    return cube_yxz[..., i] * (1.0 - f) + cube_yxz[..., i + 1] * f


def plot_pqt(weather_model, savefig: bool = True, z1: float = 500.0, z2: float = 15000.0):
    """Pressure/humidity/temperature panels in a 3x3 layout: rows 1-2 are 2-D P/E/T slices
    interpolated to z1 and z2 with the center pixel marked, row 3 the
    vertical profiles at that pixel."""
    import matplotlib.pyplot as plt

    zs = _host(weather_model._zs, np.float64)
    if zs.ndim > 1:
        zs = np.nanmean(zs, axis=(0, 1))
    p = _host(weather_model._p)
    t = _host(weather_model._t)
    e = (_host(weather_model._e)
         if weather_model._e is not None else np.full_like(p, np.nan))
    xs = _host(weather_model._xs, np.float64).ravel()
    ys = _host(weather_model._ys, np.float64).ravel()
    extent = [np.nanmin(xs), np.nanmax(xs), np.nanmin(ys), np.nanmax(ys)]
    yind, xind = p.shape[0] // 2, p.shape[1] // 2

    fig = plt.figure(figsize=(18, 14))
    fig.suptitle(
        f'{weather_model.Model()} Pressure/Humidity/Temperature at height '
        f'{z1}m and {z2}m (values should drop as elevation increases)'
    )
    panels = []
    for z in (z1, z2):
        panels += [
            (_slice_at_height(p, zs, z) / 1e2, 'P (hPa)'),
            (_slice_at_height(e, zs, z) / 1e2, 'E (hPa)'),
            (_slice_at_height(t, zs, z) - 273.15, 'T (C)'),
        ]
    for ind, (img, title) in enumerate(panels):
        sp = fig.add_subplot(3, 3, ind + 1)
        im = sp.imshow(img, cmap='viridis', extent=extent, origin='lower',
                       aspect='auto')
        sp.plot(xs[xind] if xs.size > xind else xs[-1],
                ys[yind] if ys.size > yind else ys[-1], 'ko')
        fig.colorbar(im, ax=sp, fraction=0.04, pad=0.05)
        if ind < 3:
            sp.set_title(title)
        if ind == 0:
            sp.set_ylabel(f'{z1} m\n')
        if ind == 3:
            sp.set_ylabel(f'{z2} m\n')

    zkm = zs / 1000.0
    for col, (prof, label) in enumerate((
        (p[yind, xind, :] / 1e2, 'Pressure (hPa)'),
        (e[yind, xind, :] / 1e2, 'E (hPa)'),
        (t[yind, xind, :] - 273.15, 'Temp (C)'),
    )):
        sp = fig.add_subplot(3, 3, 7 + col)
        sp.plot(prof, zkm)
        sp.set_xlabel(label)
        if col == 0:
            sp.set_ylabel('Height (km)')
    fig.subplots_adjust(top=0.95, bottom=0.1, left=0.1, right=0.95,
                        hspace=0.2, wspace=0.3)
    out = f'{weather_model.Model()}_weather_hgt{z1}_and_{z2}m.pdf'
    if savefig:
        fig.savefig(out)
    plt.close(fig)
    return out


def plot_wh(weather_model, savefig: bool = True, z1: float = 500.0, z2: float = 15000.0):
    """Wet/hydrostatic refractivity slices at two heights."""
    import matplotlib.pyplot as plt

    zs = _host(weather_model._zs, np.float64)
    if zs.ndim > 1:
        zs = np.nanmean(zs, axis=(0, 1))
    wet = _host(weather_model.getWetRefractivity())
    hydro = _host(weather_model.getHydroRefractivity())
    i1 = int(np.abs(zs - z1).argmin())
    i2 = int(np.abs(zs - z2).argmin())

    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    for ax, cube, idx, name in (
        (axes[0, 0], wet, i1, f'wet @ {zs[i1]:.0f} m'),
        (axes[0, 1], wet, i2, f'wet @ {zs[i2]:.0f} m'),
        (axes[1, 0], hydro, i1, f'hydro @ {zs[i1]:.0f} m'),
        (axes[1, 1], hydro, i2, f'hydro @ {zs[i2]:.0f} m'),
    ):
        im = ax.imshow(cube[..., idx], origin='lower', cmap='viridis')
        fig.colorbar(im, ax=ax)
        ax.set_title(name)
    fig.suptitle(f'{weather_model.Model()} refractivity')
    out = f'{weather_model.Model()}_weather_model_refractivity.pdf'
    if savefig:
        fig.savefig(out)
    plt.close(fig)
    return out
