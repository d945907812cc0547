"""Command-line entry points of the port (twins of apps/run_kitti.py and apps/run_synthetic.py)."""
