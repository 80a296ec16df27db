"""Determinism and placement-invariance checks (port of ``draco_tpu.parallel.validate``).

A pipeline whose products change from run to run on the same inputs has
a fault: a sum whose order depends on the scheduling of the card (an
``index_add_`` with repeated indices adds in the order its atomics land),
uninitialised memory, or host state leaking into a result.

- :func:`fingerprint` / :func:`compare_products`: content digests and
  detailed differences of tensors, arrays, containers and nested
  lists, tuples and dicts of them.
- :func:`assert_deterministic`: the same program on the same inputs must
  give bitwise-identical outputs across repeated runs.
- :func:`assert_sharding_invariant`: a program must give the same answer
  (within a tolerance) under every placement of its arguments.
- :func:`check_pipeline_determinism`: run a whole pipeline config twice
  and compare every routed product (CLI: ``python -m draco_tpu_torch verify``).

The host copy of a tensor is ``.cpu().numpy()`` (bfloat16 is widened to
float32 first, which is exact), so two tensors digest alike exactly when
their types, shapes and bits agree.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from . import mesh as pmesh

logger = logging.getLogger(__name__)

__all__ = [
    "DeterminismError",
    "fingerprint",
    "compare_products",
    "assert_deterministic",
    "assert_sharding_invariant",
    "mesh_placement",
    "check_pipeline_determinism",
]


class DeterminismError(RuntimeError):
    """A repeated or re-placed execution produced different results."""


def _as_host(x) -> np.ndarray:
    """An array-like (a tensor on any device included) as a host numpy array;
    a placed tensor is gathered first (a collective over its mesh)."""
    if isinstance(x, torch.Tensor):
        x = pmesh.unshard(x).detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.resolve_conj().resolve_neg().cpu().numpy()
    return np.asarray(x)


def _digest(arr: np.ndarray) -> str:
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def _is_container(obj) -> bool:
    return hasattr(obj, "datasets") and hasattr(obj, "index_map")


def fingerprint(obj) -> dict[str, str]:
    """Content digests of ``obj``, keyed by component path.

    Containers digest every dataset, index map and reverse map; tensors and
    arrays digest themselves under ``""``; lists, tuples and dicts recurse
    with indexed keys.  Other leaves (telescope objects, managers) hash to
    ``"<unchecked>"``: they are compared by presence only.
    """
    out: dict[str, str] = {}

    def visit(o, path):
        if _is_container(o):
            for name, ds in sorted(o.datasets.items()):
                out[f"{path}/{name}"] = _digest(_as_host(ds[:]))
            for name, im in sorted(o.index_map.items()):
                out[f"{path}/index_map/{name}"] = _digest(np.asarray(im))
            for name, rm in sorted(o.reverse_map.items()):
                # reverse maps are product data too: a stack order that
                # changes from run to run must not escape the check
                out[f"{path}/reverse_map/{name}"] = _digest(np.asarray(rm))
        elif isinstance(o, (list, tuple)):
            for i, v in enumerate(o):
                visit(v, f"{path}[{i}]")
        elif isinstance(o, dict):
            for k, v in sorted(o.items()):
                visit(v, f"{path}[{k!r}]")
        elif isinstance(o, (np.ndarray, torch.Tensor)):
            out[path] = _digest(_as_host(o))
        elif o is None:
            out[path] = "<none>"
        elif np.isscalar(o):
            a = np.asarray(o)
            if a.dtype == object:
                # tobytes() of an object array hashes pointers, which change
                # from run to run: digest the repr instead
                out[path] = _digest(np.frombuffer(repr(o).encode(), dtype=np.uint8))
            else:
                out[path] = _digest(a)
        else:
            out[path] = "<unchecked>"

    visit(obj, "")
    return out


def _max_diff(a, b) -> float:
    a = _as_host(a)
    b = _as_host(b)
    if a.shape != b.shape:
        return float("inf")
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
        d = np.abs(np.asarray(a, dtype=np.complex128) - b)
        return float(d.max()) if d.size else 0.0
    return 0.0 if np.array_equal(a, b) else float("inf")


def compare_products(a, b, rtol: float = 0.0) -> list[str]:
    """Differences between two product structures, as report lines.

    ``rtol`` relaxes the comparison from bitwise to a relative tolerance
    against the magnitude of the first structure (0.0 demands determinism;
    a small tolerance compares placements whose reduction orders differ).
    """
    fa, fb = fingerprint(a), fingerprint(b)
    problems = []
    for path in sorted(set(fa) | set(fb)):
        if path not in fa:
            problems.append(f"{path}: only in second run")
            continue
        if path not in fb:
            problems.append(f"{path}: only in first run")
            continue
        if fa[path] == fb[path]:
            continue
        # digests differ: quantify (walk both structures down the path)
        va, vb = _lookup(a, path), _lookup(b, path)
        if va is None or vb is None:
            problems.append(f"{path}: {fa[path]} != {fb[path]}")
            continue
        diff = _max_diff(va, vb)
        ha = _as_host(va)
        scale = float(np.abs(ha).max()) if ha.size else 0.0
        if rtol > 0.0 and diff <= rtol * max(scale, 1e-30):
            continue
        problems.append(f"{path}: max |diff| = {diff:.3e} (scale {scale:.3e})")
    return problems


def _lookup(obj, path: str):
    """Resolve a fingerprint path back to its array, or None."""
    if path == "":
        return obj
    try:
        if path.startswith("/"):
            parts = path[1:].split("/")
            if _is_container(obj):
                if parts[0] == "index_map":
                    return np.asarray(obj.index_map[parts[1]])
                if parts[0] == "reverse_map":
                    return np.asarray(obj.reverse_map[parts[1]])
                return _as_host(obj.datasets[parts[0]][:])
            return None
        if path.startswith("["):
            key, _, rest = path[1:].partition("]")
            container = obj[int(key)] if not key.startswith("'") else obj[key[1:-1]]
            return _lookup(container, rest)
    except Exception:
        return None
    return None


def assert_deterministic(
    fn: Callable,
    args: Sequence[Any] = (),
    *,
    runs: int = 2,
    rtol: float = 0.0,
    label: str = "program",
) -> None:
    """Run ``fn(*args)`` ``runs`` times; raise if the results differ.

    The outputs are compared bitwise by default (rtol=0): a program with
    fixed inputs must be reproducible; any drift means a sum in an order
    that changes, uninitialised memory, or host state leaking in.
    """
    ref = fn(*args)
    for i in range(1, runs):
        out = fn(*args)
        problems = compare_products(ref, out, rtol=rtol)
        if problems:
            raise DeterminismError(f"{label}: run {i} differs from run 0:\n  " + "\n  ".join(problems))


def assert_sharding_invariant(
    fn: Callable,
    args: Sequence[Any],
    placements: Iterable[Callable[[Any], Any]],
    *,
    rtol: float = 1e-5,
    label: str = "program",
) -> None:
    """Check ``fn`` gives the same answer under every placement.

    ``placements`` is an iterable of callables mapping each argument to its
    placed form (e.g. ``lambda x: x.to("cuda:0")``, or
    :func:`mesh_placement`'s split over a mesh: every rank of the mesh
    then runs the check); the first placement is the baseline.  The reduction order
    may change across placements, so the default comparison allows a small
    relative tolerance; pass rtol=0.0 to demand bit-identity.
    """
    ref = None
    for i, place in enumerate(placements):
        out = fn(*[place(a) for a in args])
        if i == 0:
            ref = out
            continue
        problems = compare_products(ref, out, rtol=rtol)
        if problems:
            raise DeterminismError(f"{label}: placement {i} differs from placement 0:\n  " + "\n  ".join(problems))


def mesh_placement(mesh, axis_names, primary: str | None = None) -> Callable[[Any], Any]:
    """A placement for :func:`assert_sharding_invariant`: a tensor split over
    ``mesh`` by its axis names (``shard_array_named`` under ``use_mesh``).
    A program given placed tensors returns placed ones, which the
    comparison gathers."""

    def place(x):
        with pmesh.use_mesh(mesh):
            return pmesh.shard_array_named(x, axis_names, primary)

    return place


def check_pipeline_determinism(config: "dict | str", *, runs: int = 2, rtol: float = 0.0) -> dict[str, int]:
    """Run a pipeline config ``runs`` times; compare every routed product.

    Parameters
    ----------
    config
        Pipeline YAML text or parsed config dict.
    runs
        Number of independent end-to-end executions.
    rtol
        0.0 demands bitwise reproducibility; small values tolerate
        legitimate reduction-order drift.

    Returns
    -------
    summary
        ``{"products": n_labels, "arrays": n_compared}`` on success.

    Raises
    ------
    DeterminismError
        Listing every differing product array.
    """
    from ..core.pipeline import Manager, _import_yaml

    if isinstance(config, str):
        config = _import_yaml().safe_load(config)

    reference = None
    for i in range(runs):
        products = Manager(config).run()
        if not products:
            raise DeterminismError(
                "the pipeline retained no products to compare: retain_products "
                "is probably 'none'; rerun with retain_products: all (a green "
                "check over zero arrays would be vacuous)."
            )
        if reference is None:
            reference = products
            continue
        problems = []
        for label in sorted(set(reference) | set(products)):
            pa = reference.get(label)
            pb = products.get(label)
            if pa is None or pb is None or len(pa) != len(pb):
                problems.append(f"{label}: product count {len(pa or [])} != {len(pb or [])}")
                continue
            for j, (va, vb) in enumerate(zip(pa, pb)):
                for line in compare_products(va, vb, rtol=rtol):
                    problems.append(f"{label}[{j}]{line}")
        if problems:
            raise DeterminismError(f"pipeline run {i} differs from run 0:\n  " + "\n  ".join(problems))
    n_arrays = sum(len(fingerprint(v)) for vals in (reference or {}).values() for v in vals)
    return {"products": len(reference or {}), "arrays": n_arrays}
