"""The port's native code: the prefetching PNG loader (loader.cpp, loader.py)."""
