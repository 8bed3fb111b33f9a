"""The repo's TPC-DS matrix, on the PyTorch port.

`tests/tpcds_support.py` (tables, plans of the 99 queries) and
`tests/test_tpcds_queries.py` (pandas oracles, `assert_frames_match`) are
written against `blaze_tpu`. `load()` reads their source, replaces the
module name `blaze_tpu` (word boundary) with `blaze_tpu_torch` - which
covers the imports inside functions too - and the support module's
import path with the port copy's, and executes each as a new module. No
JAX module is imported, so the copies also run where JAX is absent
(chip_smoke.py's `tpcds99` phase). Neither source file is edited.
"""

from __future__ import annotations

import os
import re
import sys
import types
from typing import Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SUPPORT = "tpcds_support_torch"
QUERIES_MODULE = "test_tpcds_queries_torch"


def _exec_copy(name: str, path: str, extra=()) -> types.ModuleType:
    with open(path) as f:
        src = f.read()
    src = re.sub(r"\bblaze_tpu\b", "blaze_tpu_torch", src)
    for old, new in extra:
        src = src.replace(old, new)
    mod = types.ModuleType(name)
    mod.__file__ = path
    sys.modules[name] = mod  # dataclasses and pickling look modules up
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def load(n_sales: Optional[int] = None
         ) -> Tuple[types.ModuleType, types.ModuleType]:
    """(support, queries): the port copies of tests/tpcds_support.py and
    tests/test_tpcds_queries.py. `n_sales` overrides the copy's
    store_sales row count (BLAZE_TPCDS_ROWS, 200,000 by default)."""
    extra = []
    if n_sales is not None:
        extra.append(('N_SALES = int(os.environ.get("BLAZE_TPCDS_ROWS", '
                      '200_000))', f"N_SALES = {int(n_sales)}"))
    support = _exec_copy(SUPPORT, os.path.join(_HERE, "tpcds_support.py"),
                         extra)
    queries = _exec_copy(
        QUERIES_MODULE, os.path.join(_HERE, "test_tpcds_queries.py"),
        [("from tests.tpcds_support import",
          f"from {SUPPORT} import")])
    return support, queries


def query_order(queries) -> list:
    return sorted(queries, key=lambda q: int(q[1:]))


RANK_TOLERANT = ("_rank_bounds", "_assert_rank_tolerant_q86",
                 "_assert_rank_tolerant_q67")


def rank_tolerant(queries: types.ModuleType) -> types.SimpleNamespace:
    """The reference's rank-tolerant comparisons of q67 and q86
    (tests/test_tpcds_exchange.py: `_rank_bounds`,
    `_assert_rank_tolerant_q86`, `_assert_rank_tolerant_q67`): those
    three functions' source, read from that file with the same rewrite
    as `load` (its `tests.test_tpcds_queries` imports pointed at
    `queries`, the port copy from `load`), executed beside numpy and
    pandas. The rest of that file, which drives the JAX package, is not
    run."""
    import ast

    import numpy as np
    import pandas as pd

    path = os.path.join(_HERE, "test_tpcds_exchange.py")
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    parts = [ast.get_source_segment(src, node) for node in tree.body
             if isinstance(node, ast.FunctionDef)
             and node.name in RANK_TOLERANT]
    if len(parts) != len(RANK_TOLERANT):
        raise RuntimeError(f"{path}: expected {RANK_TOLERANT}")
    code = "\n\n\n".join(parts).replace("from tests.test_tpcds_queries",
                                        f"from {queries.__name__}")
    ns = {"np": np, "pd": pd}
    exec(compile(code, path, "exec"), ns)
    return types.SimpleNamespace(**{n: ns[n] for n in RANK_TOLERANT})


EXCHANGE_NAMES = ("EXCHANGE_QUERIES", "RANK_TOLERANT", "N_EXCHANGE_PARTITIONS",
                  "PARQUET_QUERIES")


def exchange_queries() -> types.SimpleNamespace:
    """The query lists of tests/test_tpcds_exchange.py, read from its
    source without running it (it imports the JAX package):
    EXCHANGE_QUERIES, RANK_TOLERANT, N_EXCHANGE_PARTITIONS and
    PARQUET_QUERIES."""
    import ast

    path = os.path.join(_HERE, "test_tpcds_exchange.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in EXCHANGE_NAMES:
            found[node.targets[0].id] = ast.literal_eval(node.value)
    if set(found) != set(EXCHANGE_NAMES):
        raise RuntimeError(f"{path}: expected {EXCHANGE_NAMES}")
    return types.SimpleNamespace(**found)
