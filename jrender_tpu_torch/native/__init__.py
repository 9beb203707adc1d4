"""Native host code bound with ctypes: the OBJ parser (``native/objloader.cpp``)."""
from .objloader import ParsedObj, available, parse_obj_native
