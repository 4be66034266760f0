"""Workflows of the port: so far the DEM helpers (``dem``) that the AOIs use."""
