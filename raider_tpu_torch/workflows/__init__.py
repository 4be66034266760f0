"""Workflows of the port: the calc-delays workflow (``calc_delays``), its run
config (``config``, ``check_args``, ``yaml_subset``), Sentinel-1 timing
(``s1_timing``), the DEM helpers (``dem``) that the AOIs use, the GUNW
workflow (``gunw``, with the S3 helpers of ``aws``), the GNSS download and
combine tools (``gnss``, ``gnss_combine``), the GACOS headers
(``gacos``) and raiderStats (``stats``, its map overlay ``coastlines``)."""
