"""Object store seam for scan IO (local files only in this slice).

Reference counterpart: the HDFS object store proxy
(hdfs_object_store.rs:34-140) - the reference's native engine never
talks to storage directly; it reads through a registered ObjectStore.
The JAX package also carries memory, callback and remote-block stores;
they wait for the rest of the exchange tier (ROADMAP 'Modules to port'
item 9), and a path with a `scheme://` prefix raises until then.
"""

from __future__ import annotations


class LocalStore:
    def open_input(self, path: str):
        """File-like object for pyarrow's parquet reader: mmap'd page
        buffers, so column chunks slice straight out of the page
        cache."""
        import pyarrow as pa

        return pa.memory_map(path, "r")


_LOCAL = LocalStore()


def store_for(path: str) -> LocalStore:
    if "://" in path:
        scheme = path.split("://", 1)[0]
        raise NotImplementedError(
            f"object store scheme {scheme!r} waits for ROADMAP "
            "'Modules to port' item 9 (exchange tier, the rest); local "
            "paths only"
        )
    return _LOCAL
