"""In-memory datasets and a minimal netCDF reader/writer.

``Dataset`` and ``Variable`` are the tiny xarray-like model the delay path
hands from stage to stage; a variable's ``data`` may be a numpy array or a
torch tensor (the weather model hands its cubes over on the device).

Files: ``read_nc`` picks the format from the file's first bytes. A classic
netCDF-3 file (``CDF\x01``, ``CDF\x02``: raw CDS/MARS downloads, WRF output,
the raw files the readers write) is read by scipy and never touches h5py;
anything else is HDF5-backed netCDF4, read by h5py. ``write_nc`` writes
netCDF4 through h5py (``nc_format='NETCDF4'``, the default, the JAX
package's schema) or, when the caller asks for ``'NETCDF3_64BIT_OFFSET'``,
classic netCDF-3 with 64-bit offsets (CDF-2) through scipy; it never
switches format by itself. h5py is imported inside those functions only,
so the package reads and writes classic files on a machine without h5py.

Classic netCDF-3 holds less than netCDF4. What the writer does with each
value it cannot hold as it is (``read_nc`` decodes each encoding back):

* int64 data (the 0-d ``proj``/``crs`` grid mappings): stored as int32 with
  the variable attribute ``_nc3_dtype = 'int64'``; read back as int64.
  Values outside the int32 range are refused (ValueError).
* bool data: stored as int8 with ``_nc3_dtype = 'bool'``; read back as bool.
  Any other dtype classic netCDF lacks (unsigned, complex, strings) is
  refused.
* A list of strings as an attribute (``model_times_used``): the strings
  joined by newlines in one text attribute, its name listed in the
  attribute ``_nc3_string_lists`` of the same variable or of the file;
  read back as the list. A string holding a newline, or an empty list, is
  refused.
* A bool attribute: stored as int8 0 or 1, its name listed in
  ``_nc3_bools``; read back as ``numpy.bool_``.
* Text with non-ASCII characters: stored as its UTF-8 bytes in a text
  attribute (what netCDF-C does); read back as the same ``str``.
* Integer attributes are stored as int32 (a value outside that range is
  refused) and Python floats as float64 (scipy on its own would store
  float32): each reads back equal to the value written, as a numpy scalar.
* ``group=`` and ``mode='a'`` are netCDF4 only (GUNW products need
  groups): with netCDF-3 they raise ValueError.
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
NC_FORMATS = ('NETCDF4', 'NETCDF3_64BIT_OFFSET')
# the attributes that mark the netCDF-3 encodings (see the module docstring)
_NC3_DTYPE = '_nc3_dtype'
_NC3_STRING_LISTS = '_nc3_string_lists'
_NC3_BOOLS = '_nc3_bools'
_NC3_MARKERS = (_NC3_DTYPE, _NC3_STRING_LISTS, _NC3_BOOLS)
_INT32 = np.iinfo(np.int32)


def _nc3_attrs(raw: dict) -> dict:
    """Attributes of a classic file as written, the encodings of
    :func:`_write_nc3` decoded: text as ``str``, arrays in native byte
    order, string lists and bools restored."""
    attrs = {}
    for k, v in raw.items():
        if isinstance(v, bytes):
            v = v.decode('utf-8')
        elif isinstance(v, np.ndarray):
            v = v.astype(v.dtype.newbyteorder('='))
        attrs[k] = v
    for k in attrs.pop(_NC3_STRING_LISTS, '').split():
        attrs[k] = attrs[k].split('\n')
    for k in attrs.pop(_NC3_BOOLS, '').split():
        attrs[k] = np.asarray(attrs[k]).astype(bool)[()]
    return attrs


def _read_nc3(path: Union[str, Path]) -> Dataset:
    """A classic (netCDF-3) file, read by scipy."""
    from scipy.io import netcdf_file

    out = Dataset()
    with netcdf_file(str(path), 'r', maskandscale=True, mmap=False) as f:
        out.attrs = _nc3_attrs(f._attributes)
        dims = set(f.dimensions.keys())
        for name, var in f.variables.items():
            # var[...], not var[:]: a 0-d variable (a CF grid mapping) takes no slice
            data = np.asarray(var[...] if var.data is not None else var.getValue())
            data = data.astype(data.dtype.newbyteorder('='))  # netCDF-3 is big-endian
            attrs = _nc3_attrs(var._attributes)
            stored = attrs.pop(_NC3_DTYPE, None)
            if stored is not None:
                data = data.astype(stored)
            if name in dims and data.ndim == 1:
                out.coords[name] = Variable((name,), data, attrs)
            else:
                out.variables[name] = Variable(tuple(var.dimensions), data, attrs)
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
             mode: str = 'w', *, nc_format: str = 'NETCDF4') -> str:
    """Write a Dataset (device tensors are copied to the host first):
    netCDF4-flavored HDF5 through h5py, or with
    ``nc_format='NETCDF3_64BIT_OFFSET'`` classic netCDF-3 through scipy in
    the encodings of the module docstring."""
    if nc_format not in NC_FORMATS:
        raise ValueError(f'write_nc: nc_format {nc_format!r} is not one of {NC_FORMATS}')
    if nc_format == 'NETCDF3_64BIT_OFFSET':
        if group is not None or mode != 'w':
            raise ValueError('write_nc: groups and appending (group=, mode="a") need '
                             "nc_format='NETCDF4'; netCDF-3 has neither")
        return _write_nc3(ds, str(path))
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("write_nc: nc_format='NETCDF4' needs h5py, which is not installed; "
                          "pass nc_format='NETCDF3_64BIT_OFFSET' to write classic netCDF-3 "
                          'through scipy') from exc

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


def _nc3_int32(a: np.ndarray, what: str) -> np.ndarray:
    if a.size and (a.min() < _INT32.min or a.max() > _INT32.max):
        raise ValueError(f'write_nc (netCDF-3): {what} holds integers outside the int32 range, '
                         'which classic netCDF cannot store')
    return a.astype(np.int32)


def _nc3_attr_values(attrs: dict, what: str) -> dict:
    """Attributes as scipy must be given them for a classic file, with the
    encodings of the module docstring (their marker attributes added)."""
    out, lists, bools = {}, [], []
    for k, v in attrs.items():
        where = f'attribute {k!r} of {what}'
        if k in _NC3_MARKERS:
            raise ValueError(f'write_nc (netCDF-3): {where} uses a name the netCDF-3 '
                             'encodings reserve')
        if isinstance(v, str):
            out[k] = v.encode('utf-8')
            continue
        if isinstance(v, (list, tuple)) and v and all(isinstance(x, str) for x in v):
            if any('\n' in x for x in v):
                raise ValueError(f'write_nc (netCDF-3): {where} is a list of strings holding '
                                 'a newline, which its encoding cannot store')
            out[k] = '\n'.join(v).encode('utf-8')
            lists.append(k)
            continue
        a = np.asarray(v)
        if a.size == 0 or a.ndim > 1:
            raise ValueError(f'write_nc (netCDF-3): {where} ({v!r}) is empty or not flat')
        if a.dtype.kind == 'b':
            out[k] = a.astype(np.int8)
            bools.append(k)
        elif a.dtype.kind in 'iu':
            out[k] = (a if a.dtype in (np.int8, np.int16, np.int32) else _nc3_int32(a, where))
        elif a.dtype in (np.float32, np.float64):
            out[k] = a
        else:
            raise ValueError(f'write_nc (netCDF-3): {where} has type {type(v).__name__} '
                             f'({a.dtype}), which classic netCDF cannot store')
    if lists:
        out[_NC3_STRING_LISTS] = ' '.join(lists).encode()
    if bools:
        out[_NC3_BOOLS] = ' '.join(bools).encode()
    return out


_NC3_TYPES = {np.dtype(np.float64): 'd', np.dtype(np.float32): 'f', np.dtype(np.int32): 'i',
              np.dtype(np.int16): 'h', np.dtype(np.int8): 'b'}


def _nc3_data(data, name: str) -> tuple:
    """(host array in a classic type, its type code, the ``_nc3_dtype``
    marker or None) of a variable's data."""
    a = to_numpy(data)
    if a.dtype.kind == 'b':
        return a.astype(np.int8), 'b', 'bool'
    if a.dtype == np.int64:
        return _nc3_int32(a, f'variable {name!r}'), 'i', 'int64'
    a = a.astype(a.dtype.newbyteorder('='))
    if a.dtype not in _NC3_TYPES:
        raise ValueError(f'write_nc (netCDF-3): variable {name!r} has dtype {a.dtype}, which '
                         'classic netCDF cannot store')
    return a, _NC3_TYPES[a.dtype], None


def _write_nc3(ds: Dataset, path: str) -> str:
    from scipy.io import netcdf_file

    sizes = {}
    for name, var in list(ds.coords.items()) + list(ds.variables.items()):
        for dim, size in zip(var.dims, np.shape(var.data)):
            if sizes.setdefault(dim, size) != size:
                raise ValueError(f'write_nc: dimension {dim!r} has sizes {sizes[dim]} and {size}')
    for name, var in ds.variables.items():
        if name in sizes and np.ndim(var.data) == 1 and tuple(var.dims) == (name,):
            raise ValueError(f'write_nc (netCDF-3): variable {name!r} along its own dimension '
                             'would read back as a coordinate; put it in coords')
    global_attrs = _nc3_attr_values(ds.attrs, 'the file')
    with netcdf_file(path, 'w', version=2) as f:
        # into _attributes: setattr could clobber a field of scipy's own
        f._attributes.update(global_attrs)
        for dim, size in sizes.items():
            f.createDimension(dim, size)
        for name, var in list(ds.coords.items()) + list(ds.variables.items()):
            data, code, stored = _nc3_data(var.data, name)
            out = f.createVariable(name, code, tuple(var.dims))
            out[...] = data
            out._attributes.update(_nc3_attr_values(var.attrs, f'variable {name!r}'))
            if stored is not None:
                out._attributes[_NC3_DTYPE] = stored.encode()
    return path
