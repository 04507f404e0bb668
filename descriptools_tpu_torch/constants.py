"""Universal conventions of the terrain-descriptor suite.

The reference toolbox (JVBSouza/descriptools) bakes these conventions into
every kernel; we centralise them here.  Citations are file:line into the
reference for parity checking:

- NoData sentinel ``-100`` in value rasters (slope.py:23, gfi.py:289).
- "Needs repair" sentinel ``-50`` (downslope.py:527, flowhand.py:283) — only
  meaningful in the reference's two-phase GPU+CPU-repair protocol; our
  device-resident pointer-jumping design never needs it, but the constant is
  kept for API familiarity.
- D8 flow direction, ESRI encoding (downslope.py:76-127):
  1=E, 2=SE, 4=S, 8=SW, 16=W, 32=NW, 64=N, 128=NE.
- Diagonal steps cost ``px*sqrt(2)``, cardinal steps ``px`` (slope.py:255).
- Epsilon ``+0.01`` guards log/0 divisions in TWI/GFI/ln(hl/H)
  (topoindexes.py:257, gfi.py:294, gfi.py:435).
"""

import math

import numpy as np

# Sentinels --------------------------------------------------------------
NODATA = -100
REPAIR = -50

# Epsilon used inside TWI / GFI / ln(hl/H) formulas (reference GPU variants).
EPS = 0.01

SQRT2 = math.sqrt(2.0)

# D8 flow-direction encoding (ESRI). Order: E, SE, S, SW, W, NW, N, NE.
D8_CODES = np.array([1, 2, 4, 8, 16, 32, 64, 128], dtype=np.int32)
D8_DY = np.array([0, 1, 1, 1, 0, -1, -1, -1], dtype=np.int32)
D8_DX = np.array([1, 1, 0, -1, -1, -1, 0, 1], dtype=np.int32)
# Step length in pixels (multiply by px for metres).
D8_STEP = np.array(
    [1.0, SQRT2, 1.0, SQRT2, 1.0, SQRT2, 1.0, SQRT2], dtype=np.float32
)

# Walk caps of the reference kernels (downslope.py:519, flowhand.py:835).
DOWNSLOPE_MAX_STEPS = 5000
FLOW_MAX_STEPS = 20000
