"""Host-side hashing without a native library: HighwayHash-256 and MUR3X256
in numpy (the port carries no ctypes CPU library of its own)."""
