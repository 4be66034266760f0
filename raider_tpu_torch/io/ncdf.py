"""In-memory datasets and a minimal netCDF4 reader/writer.

``Dataset`` and ``Variable`` are the tiny xarray-like model the delay path
hands from stage to stage; a variable's ``data`` may be a numpy array or a
torch tensor (the weather model hands its cubes over on the device).

Files: ``read_nc`` picks the format from the file's first bytes. A classic
netCDF-3 file (``CDF\x01``, ``CDF\x02``: raw CDS/MARS downloads, WRF output,
the raw files the readers write) is read by scipy and never touches h5py;
anything else is HDF5-backed netCDF4, read by h5py. ``write_nc`` writes
netCDF4 through h5py. h5py is imported inside those functions only, so the
package reads classic files on a machine without h5py. Same file schema as
``raider_tpu.io.ncdf``.
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Union

import numpy as np


@dataclass
class Variable:
    dims: tuple
    data: object
    attrs: dict = field(default_factory=dict)


@dataclass
class Dataset:
    """In-memory dataset: dims are implied by coords/variables."""

    coords: dict = field(default_factory=dict)       # name -> Variable
    variables: dict = field(default_factory=dict)    # name -> Variable
    attrs: dict = field(default_factory=dict)

    def __getitem__(self, name: str) -> Variable:
        if name in self.variables:
            return self.variables[name]
        return self.coords[name]

    def __contains__(self, name: str) -> bool:
        return name in self.variables or name in self.coords

    @property
    def dims(self) -> dict:
        out = {}
        for var in list(self.coords.values()) + list(self.variables.values()):
            for d, s in zip(var.dims, np.shape(var.data)):
                out[d] = s
        return out


def to_numpy(data) -> np.ndarray:
    """Host numpy view of a variable's data (copies a device tensor back)."""
    if hasattr(data, 'detach'):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _decode_attr(v):
    if isinstance(v, bytes):
        return v.decode('utf-8', 'replace')
    if isinstance(v, np.bytes_):
        return bytes(v).decode('utf-8', 'replace')
    if isinstance(v, np.ndarray) and v.dtype.kind == 'S':
        return [bytes(x).decode('utf-8', 'replace') for x in v.ravel()]
    if isinstance(v, np.ndarray) and v.size == 1:
        return v.ravel()[0]
    return v


def _read_attrs(obj) -> dict:
    return {
        k: _decode_attr(v)
        for k, v in obj.attrs.items()
        if not k.startswith(('_Netcdf', 'CLASS', 'NAME', 'DIMENSION_LIST', 'REFERENCE_LIST'))
        and k != '_NCProperties'
    }


# netCDF4's marker for a dimension without a coordinate variable
_PURE_DIM_NAME = 'This is a netCDF dimension but not a netCDF variable.'


def _maskandscale(data, attrs: dict):
    """CF unpacking: mask _FillValue/missing_value to NaN and apply
    scale_factor/add_offset; the packing attrs are consumed."""
    scale = attrs.pop('scale_factor', None)
    offset = attrs.pop('add_offset', None)
    fill = attrs.pop('_FillValue', attrs.pop('missing_value', None))
    if scale is None and offset is None:
        if fill is not None and np.ndim(data) and np.asarray(data).dtype.kind == 'f':
            data = np.where(np.asarray(data) == fill, np.nan, data)
        return data
    data = np.asarray(data, dtype=np.float64)
    mask = (data == float(fill)) if fill is not None else None
    if scale is not None:
        data = data * float(scale)
    if offset is not None:
        data = data + float(offset)
    if mask is not None:
        data = np.where(mask, np.nan, data)
    return data


_NC3_MAGIC = (b'CDF\x01', b'CDF\x02')


def _read_nc3(path: Union[str, Path]) -> Dataset:
    """A classic (netCDF-3) file, read by scipy."""
    from scipy.io import netcdf_file

    def _dec(attrs):
        return {k: (v.decode() if isinstance(v, bytes) else v) for k, v in attrs.items()}

    out = Dataset()
    with netcdf_file(str(path), 'r', maskandscale=True, mmap=False) as f:
        out.attrs = _dec(f._attributes)
        dims = set(f.dimensions.keys())
        for name, var in f.variables.items():
            # var[...], not var[:]: a 0-d variable (a CF grid mapping) takes no slice
            data = np.asarray(var[...] if var.data is not None else var.getValue())
            data = data.astype(data.dtype.newbyteorder('='))  # netCDF-3 is big-endian
            if name in dims and data.ndim == 1:
                out.coords[name] = Variable((name,), data, _dec(var._attributes))
            else:
                out.variables[name] = Variable(tuple(var.dimensions), data, _dec(var._attributes))
    return out


def read_nc(path: Union[str, Path], group: Optional[str] = None) -> Dataset:
    """Read a netCDF file, optionally a sub-group of a netCDF4 one: classic
    netCDF-3 through scipy, HDF5-backed netCDF4 through h5py."""
    with open(path, 'rb') as fh:
        magic = fh.read(4)
    if magic in _NC3_MAGIC:
        if group is not None:
            raise ValueError(f'{path} is a classic netCDF-3 file, which has no groups')
        return _read_nc3(path)
    import h5py

    out = Dataset()
    with h5py.File(path, 'r') as f:
        root = f[group] if group else f
        out.attrs = _read_attrs(root)
        scale_names, pure_dims = set(), set()
        for name, obj in root.items():
            if isinstance(obj, h5py.Dataset) and obj.attrs.get('CLASS', b'') in (
                    b'DIMENSION_SCALE', 'DIMENSION_SCALE'):
                scale_names.add(name)
                nm = obj.attrs.get('NAME', b'')
                nm = nm.decode('utf-8', 'replace') if isinstance(nm, bytes) else str(nm)
                if nm.startswith(_PURE_DIM_NAME):
                    pure_dims.add(name)
        for name, obj in root.items():
            if not isinstance(obj, h5py.Dataset) or name in pure_dims:
                continue
            attrs = _read_attrs(obj)
            data = _maskandscale(obj[()], attrs)
            if name in scale_names:
                out.coords[name] = Variable((name,), np.asarray(data), attrs)
                continue
            dims = []
            for i in range(obj.ndim):
                scales = obj.dims[i]
                dims.append(scales[0].name.rsplit('/', 1)[-1] if len(scales) else f'dim_{i}')
            if any(d.startswith('dim_') for d in dims):
                # no attached scale: match the axis to a coordinate by its length
                bylen = {}
                for cn in (k for k in root if k in scale_names):
                    if root[cn].ndim == 1:
                        bylen.setdefault(root[cn].shape[0], cn)
                dims = [bylen.get(n, d) for n, d in zip(np.shape(data), dims)]
            out.variables[name] = Variable(tuple(dims), np.asarray(data) if np.ndim(data) else data,
                                           attrs)
    return out


def write_nc(ds: Dataset, path: Union[str, Path], group: Optional[str] = None,
             mode: str = 'w') -> str:
    """Write a Dataset as a netCDF4-flavored HDF5 file (device tensors are
    copied to the host first)."""
    import h5py

    path = str(path)
    with h5py.File(path, mode) as f:
        root = f.require_group(group) if group else f
        if group is None and mode == 'w':
            f.attrs['_NCProperties'] = np.bytes_('version=2,netcdf=4.9.2,hdf5=1.14.0')
        str_t = h5py.string_dtype('utf-8')

        def _set_attrs(obj, attrs):
            for k, v in attrs.items():
                if isinstance(v, str):
                    obj.attrs[k] = np.bytes_(v)
                elif isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
                    obj.attrs.create(k, np.array(v, dtype=str_t))
                else:
                    obj.attrs[k] = v

        _set_attrs(root, ds.attrs)
        for name, var in ds.coords.items():
            d = root.create_dataset(name, data=to_numpy(var.data))
            d.make_scale(name)
            _set_attrs(d, var.attrs)

        phantom = {}
        taken = set(ds.coords) | set(ds.variables)
        for var in ds.variables.values():
            for dim, size in zip(var.dims, np.shape(var.data)):
                if dim not in ds.coords and dim not in phantom:
                    nm = dim if dim not in taken else f'_dim_{dim}'
                    pd_ = root.create_dataset(nm, data=np.zeros(size, np.float32))
                    pd_.make_scale(dim)
                    pd_.attrs['NAME'] = np.bytes_(f'{_PURE_DIM_NAME}{size:10d}')
                    phantom[dim] = pd_

        for name, var in ds.variables.items():
            d = root.create_dataset(name, data=to_numpy(var.data))
            for i, dim in enumerate(var.dims):
                if dim in ds.coords:
                    d.dims[i].attach_scale(root[dim])
                elif dim in phantom:
                    d.dims[i].attach_scale(phantom[dim])
            _set_attrs(d, var.attrs)
    return path
