"""Test-support subsystems that ship inside the engine package.

chaos.py - deterministic fault injection (the chaos harness). Lives in
the production package (not tests/) because the injection points are
threaded through the runtime and the hooks must be importable wherever
the engine runs - including cluster worker subprocesses, which inherit
a fault plan through the BLAZE_CHAOS environment variable.
"""
