"""Host-side C++ of the port, built with g++ at first use and bound with
ctypes."""

from randomprojection_tpu_torch.native.build import load_murmur3

__all__ = ["load_murmur3"]
