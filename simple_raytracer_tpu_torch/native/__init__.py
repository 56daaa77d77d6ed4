"""The port's native host code: the median BVH build and the OBJ scan in
C++ (``native.cpp``), bound with ctypes, built with g++ at first use."""

from .build import get_lib, native_available
from .api import bvh_build_native, obj_parse_native

__all__ = ["get_lib", "native_available", "bvh_build_native",
           "obj_parse_native"]
