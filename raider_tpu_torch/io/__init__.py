"""Datasets in memory, and netCDF files for them (h5py only inside the readers)."""

from raider_tpu_torch.io.ncdf import Dataset, Variable, read_nc, write_nc  # noqa: F401
