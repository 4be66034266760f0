"""Workflows of the port: the calc-delays workflow (``calc_delays``), its run
config (``config``, ``check_args``, ``yaml_subset``), Sentinel-1 timing
(``s1_timing``) and the DEM helpers (``dem``) that the AOIs use."""
