"""Plan rewrites applied to a decoded task (planner/fuse.py)."""
