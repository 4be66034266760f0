"""A synthetic GUNW product (netCDF4/HDF5, written with h5py, imported
here) holding a ``workflows.gunw.GUNWMetadata`` record's values, in the
layout ARIA's products have and the JAX package's tests build: the
bounding-box polygon, the wavelength, both epochs' input granules, the
``science/grids/data`` latitude/longitude grid and an empty troposphere
group. Used by ``chip_smoke.py`` (phase 11a, where h5py can be imported).
"""

import numpy as np


def write_gunw(path, meta, grid=(20, 25)) -> str:
    """Write the product at ``path``; the data grid spans
    ``meta.data_extent`` with ``grid`` (latitudes, longitudes) nodes."""
    import h5py

    with h5py.File(path, 'w') as f:
        f.create_dataset('productBoundingBox', data=np.array([meta.bbox_wkt.encode()]))
        md = f.create_group('science/radarMetaData')
        md.create_dataset('wavelength', data=meta.wavelength)
        for rs in ('reference', 'secondary'):
            md.create_dataset(f'inputSLC/{rs}/L1InputGranules',
                              data=np.array([g.encode() for g in meta.granules[rs]]))
        gd = f.create_group('science/grids/data')
        w, s, e, n = meta.data_extent
        for name, axis in (('latitude', np.linspace(s, n, grid[0])),
                           ('longitude', np.linspace(w, e, grid[1]))):
            gd.create_dataset(name, data=axis).make_scale(name)
        f.create_group('science/grids/corrections/external/troposphere')
    return str(path)
