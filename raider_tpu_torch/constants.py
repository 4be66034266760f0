"""Physical constants and framework-wide defaults.

Values mirror the reference defaults (reference: tools/RAiDER/constants.py:11-23)
so that delay outputs agree numerically.
"""

import numpy as np

# Vertical integration defaults
_ZMIN = np.float64(-100.0)   # minimum required height [m]
_ZREF = np.float64(26000.0)  # default max integration height [m]
_STEP = np.float64(15.0)     # integration step size [m]

# Gravity
_g0 = np.float64(9.80665)    # standard gravity [m/s^2]
_g1 = np.float64(9.80616)    # gravity at 45 deg latitude [m/s^2]

# Earth radii
_RE = np.float64(6371008.7714)
R_EARTH_MAX_WGS84 = 6378137.0
R_EARTH_MIN_WGS84 = 6356752.0

# WGS84 ellipsoid
WGS84_A = np.float64(6378137.0)                 # semi-major axis [m]
WGS84_INV_F = np.float64(298.257223563)         # inverse flattening
WGS84_F = 1.0 / WGS84_INV_F
WGS84_B = WGS84_A * (1.0 - WGS84_F)             # semi-minor axis [m]
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)            # first eccentricity squared
WGS84_EP2 = WGS84_E2 / (1.0 - WGS84_E2)         # second eccentricity squared

# Output cube defaults
_CUBE_SPACING_IN_M = float(2000)    # horizontal cube spacing [m]
_THRESHOLD_SECONDS = 1 * 60         # time-interpolation threshold [s]

# Raytracing discretization (reference: tools/RAiDER/delay.py:228)
MAX_SEGMENT_LENGTH = 1000.0          # max ray-segment length [m]

# Gas constants (reference: tools/RAiDER/models/weatherModel.py:75-76)
R_V = np.float64(461.524)    # water vapor gas constant [J/(kg K)]
R_D = np.float64(287.06)     # dry air gas constant [J/(kg K)]
