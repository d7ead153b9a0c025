"""Native (C++) host code of the calibration pipeline.

`histogram.cpp` builds the activation histograms (exact O(n) order
statistics and an OpenMP counting pass, bit-identical to the numpy
semantics) over the hundreds of millions of captured values a 7B
calibration produces. `loader.get_lib` builds it with `g++` at first use
and raises when it cannot.
"""

from teal_tpu_torch.native.loader import get_lib

__all__ = ["get_lib"]
