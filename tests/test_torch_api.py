"""The port's public signatures cover the JAX package's.

For every public function, and every public method (and ``__init__``) of
a public class, defined at the same module path in ``waldboost_tpu/``
and ``waldboost_tpu_torch/``, the port must accept every parameter name
the JAX package's accepts (or take ``**kwargs``), so that code written
for the JAX package runs on the port.  Read from the sources (the AST),
so no module is imported.  The exceptions below are listed with their
reasons; an exception that no longer applies fails the test, so the list
stays true.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (module, qualified name) -> (parameters the port does not take, why)
EXCEPTIONS = {
    ("ops.cascade", "cascade_response_grid"): (
        {"chns", "meta", "init_alive"},
        "internal op, another operand layout: the port takes a (B, C, H, W) "
        "batch and a valid mask, its tables carry the tree meta"),
    ("ops.cascade", "cascade_survivor_counts"): (
        {"chns", "meta", "init_alive"},
        "internal op, the same layout as cascade_response_grid's"),
    ("ops.fit", "fit_tree_complete"): (
        {"hist_mode"},
        "the TPU's histogram backend switch (ROADMAP A13); the port has one "
        "fit"),
    ("packing", "PackedPyramidPlan.build"): (
        {"lane_align"},
        "TPU lane alignment of the canvas columns; the H100 has no lanes"),
    ("parallel.bucket", "bucket_geometry"): (
        {"smooth", "exact"},
        "internal op, another operand layout: the port returns the bucket's "
        "packed plan and derives the tables from it"),
    ("parallel.detect", "make_batched_detector"): (
        {"donate", "_parts", "_raw", "_shared"},
        "XLA buffer donation and the JAX package's internal program parts"),
    ("training", "DTree.as_proto"): (
        {"proto"}, "protobuf objects: the port has no protobuf (ROADMAP A13)"),
    ("training", "DTree.from_proto"): (
        {"proto"}, "protobuf objects: the port has no protobuf (ROADMAP A13)"),
}


def public_defs(package):
    """``(module, qualified name) -> FunctionDef`` of a package's public
    top-level functions and its public classes' public methods and
    ``__init__``."""
    out = {}
    base = os.path.join(ROOT, package)
    for dirpath, _, files in os.walk(base):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            mod = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in tree.body:
                if getattr(node, "name", "_").startswith("_"):
                    continue
                if isinstance(node, ast.FunctionDef):
                    out[(mod, node.name)] = node
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, ast.FunctionDef) and (
                                not sub.name.startswith("_")
                                or sub.name == "__init__"):
                            out[(mod, f"{node.name}.{sub.name}")] = sub
    return out


def accepted(fn):
    """The parameter names a def takes, and whether it takes ``**``."""
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    return names - {"self", "cls"}, a.kwarg is not None


JAX_DEFS = public_defs("waldboost_tpu")
PORT_DEFS = public_defs("waldboost_tpu_torch")
SHARED = sorted(set(JAX_DEFS) & set(PORT_DEFS))


def test_the_packages_share_their_entry_points():
    """The comparison covers the serving and training entries (a guard
    against a walk that finds nothing)."""
    assert len(SHARED) > 150
    for key in [("parallel.detect", "make_batched_detector_boxes"),
                ("parallel.detect", "detect_batch"),
                ("verification", "verify_scores"),
                ("model", "Model.append"), ("model", "Model.detect"),
                ("parallel.mesh", "make_mesh"),
                ("parallel.mesh", "shard_array"),
                ("ops.cascade", "cascade_suffix_sparse"),
                ("ops.nms", "extract_detections_rowwise"),
                ("__init__", "train")]:
        assert key in SHARED, key


@pytest.mark.parametrize("key", SHARED, ids=lambda k: f"{k[0]}:{k[1]}")
def test_port_accepts_jax_parameter_names(key):
    want, _ = accepted(JAX_DEFS[key])
    have, var_kw = accepted(PORT_DEFS[key])
    missing = set() if var_kw else want - have
    allowed, why = EXCEPTIONS.get(key, (set(), None))
    assert missing == allowed, (
        f"{key}: the port does not take {sorted(missing - allowed)}"
        if missing - allowed else
        f"{key}: listed exception {sorted(allowed - missing)} no longer "
        f"applies ({why})")


def test_exceptions_name_shared_definitions():
    for key, (names, why) in EXCEPTIONS.items():
        assert key in SHARED and names and why, key
