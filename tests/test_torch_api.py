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


# ---------------------------------------------------------------------------
# completeness: every public name of the JAX package exists in the port
# ---------------------------------------------------------------------------

#: public names of the JAX package the port does not define, with why:
#: (module, name) -> reason; name "*" stands for the whole module, and a
#: class's entry covers its members
MISSING = {
    ("ops.plane_pallas", "*"): "Pallas kernel B1 and its plans (queue B: "
    "csrc/planes.cu)",
    ("ops.channels_pallas", "*"): "Pallas kernels B2, B2d, B2f and B5 and "
    "their plans (queue B: csrc/grad_hist*.cu, csrc/fpga.cu)",
    ("ops.cascade_pallas", "*"): "Pallas kernel B6 (queue B: "
    "csrc/cascade.cu)",
    ("ops.cascade_static", "cascade_grid"): "the Pallas walk's grid plan",
    ("ops.cascade_static", "BLOCK"): "the Pallas walk's block of origins",
    ("ops.cascade_static", "cascade_masked_grid_static"): "Pallas kernel B3 "
    "(queue B: csrc/cascade.cu, csrc/cascade_fast.cu)",
    ("ops.cascade_static", "cascade_response_grid_static"): "Pallas kernel "
    "B4 (queue B: csrc/cascade.cu)",
    ("ops.dd", "*"): "double-float emulation of f64; the H100 has native "
    "f64",
    ("ops.warp", "*"): "the MXU selector-matmul resize and its halos; the "
    "port gathers its taps",
    ("ops.exact", "ProjectionPlan"): "f32 projection plans exact on the "
    "TPU; the port projects in native f64",
    ("ops.exact", "projection_plan"): "as ProjectionPlan",
    ("ops.exact", "project_bins"): "as ProjectionPlan",
    ("ops.exact", "combine4_exact"): "f32 emulation of an exact floor "
    "division; the port divides int64",
    ("ops.exact", "combine_kind"): "as combine4_exact",
    ("ops.exact", "floor_colstage"): "as combine4_exact",
    ("ops.exact", "floordiv_exact"): "as combine4_exact",
    ("ops.exact", "floordiv_exact_rt"): "as combine4_exact",
    ("ops.exact", "resize_exact_matmul"): "the MXU matmul resize",
    ("ops.exact", "resize_exact_matmul_rt"): "the MXU matmul resize",
    ("ops.exact", "resize_lerp_rt"): "the MXU matmul resize",
    ("ops.image", "avg_pool_2_u8_matmul"): "the MXU form of avg_pool_2",
    ("ops.image", "avg_pool_2_u8values_f32"): "the MXU form of avg_pool_2",
    ("model", "DEEP_STATIC_MAX"): "the static Pallas walk's stage limit",
    ("channels", "ChannelFunction.canvas_fn"): "an XLA callable; the port "
    "has ChannelFunction.canvas",
    ("channels", "ChannelFunction.canvas_fn_poly"): "an XLA callable",
    ("channels", "ChannelFunction.poly_kernel"): "a Pallas callable",
    ("channels", "ChannelFunction.poly_kernel_mask"): "a Pallas callable's "
    "operand",
    ("channels", "ChannelFunction.poly_kernel_smooth"): "a Pallas "
    "callable's option",
    ("channels", "CanvasCtx"): "internal to the XLA canvas callables",
    ("parallel.mesh", "data_sharding"): "returns an XLA NamedSharding",
    ("parallel.mesh", "replicated"): "returns an XLA NamedSharding",
    ("proto", "*"): "protobuf; the port writes the same bytes "
    "(model_io.py)",
    ("proto.model_pb2", "*"): "protobuf, as proto",
    ("polyphase_fused", "*"): "the TPU's fused selector-einsum plane build",
    ("model", "set_channel_backend"): "A13's remainder: a switch among "
    "JAX's TPU and XLA versions",
    ("model", "set_cascade_backend"): "A13's remainder, as "
    "set_channel_backend",
    ("ops.fit", "hist_mode_from_env"): "A13's remainder, as "
    "set_channel_backend",
    ("model", "Model.as_proto"): "A13's remainder: protobuf objects",
    ("model", "Model.from_proto"): "A13's remainder: protobuf objects",
    ("mining", "prewarm_mining_buckets"): "A13's remainder: XLA compile "
    "warm-up",
    ("mining", "prewarm_next_mining_bucket"): "A13's remainder, as "
    "prewarm_mining_buckets",
    ("mining", "join_prewarm_threads"): "A13's remainder, as "
    "prewarm_mining_buckets",
    ("ops.nms", "extract_detections_approx"): "A13's remainder: the port's "
    "exact extraction equals it whenever it is complete",
}


def package_modules(package):
    """``module -> AST`` of a package (a subpackage under its own name)."""
    out = {}
    base = os.path.join(ROOT, package)
    for dirpath, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                mod = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[:-len(".__init__")]
                with open(path) as f:
                    out[mod] = ast.parse(f.read())
    return out


def _targets(node):
    ts = node.targets if isinstance(node, ast.Assign) else \
        [node.target] if isinstance(node, ast.AnnAssign) else []
    return [t.id for t in ts if isinstance(t, ast.Name)]


def public_names(tree, defined_only):
    """A module's public names: its top-level defs, classes and
    assignments, its ``__all__``, and its public classes' public methods
    and ``__call__``, class-level aliases (``a = b``) and annotated fields.
    Without ``defined_only`` (the port's side) imported names and every
    class-level assignment count as present too."""
    out = set()
    for node in tree.body:
        out.update(_targets(node))
        if isinstance(node, ast.Assign) and "__all__" in _targets(node):
            out.update(e.value for e in node.value.elts)
        if isinstance(node, (ast.Import, ast.ImportFrom)) \
                and not defined_only:
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        out.add(node.name)
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef):
                if not sub.name.startswith("_") or sub.name == "__call__":
                    out.add(f"{node.name}.{sub.name}")
            elif isinstance(sub, ast.AnnAssign) or not defined_only or (
                    isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Name)):
                out.update(f"{node.name}.{t}" for t in _targets(sub))
    return {n for n in out
            if not n.split(".")[-1].startswith("_") or n.endswith(".__call__")}


JAX_MODULES = package_modules("waldboost_tpu")
PORT_MODULES = package_modules("waldboost_tpu_torch")


def missing_from_port():
    """``(module, name)`` of every public JAX name the port lacks; a
    missing module is ``(module, "*")``."""
    out = set()
    for mod, tree in JAX_MODULES.items():
        if mod not in PORT_MODULES:
            out.add((mod, "*"))
            continue
        have = public_names(PORT_MODULES[mod], defined_only=False)
        out.update((mod, n) for n in public_names(tree, defined_only=True)
                   - have)
    return out


def _excepted(key):
    mod, name = key
    return (mod, "*") in MISSING or (mod, name.split(".")[0]) in MISSING \
        or key in MISSING


def test_port_defines_every_public_jax_name():
    """Every public def, class-level alias, dataclass field and ``__all__``
    name of the JAX package exists at the same module path in the port,
    save MISSING's exceptions; an exception that no longer applies
    fails."""
    missing = missing_from_port()
    assert sorted(k for k in missing if not _excepted(k)) == []
    used = {k for k in MISSING if k in missing
            or any(m[0] == k[0] and m[1].split(".")[0] == k[1]
                   for m in missing)}
    assert sorted(set(MISSING) - used) == [], "exceptions that no longer " \
        "apply"


def test_completeness_check_sees_what_it_must():
    """The walk finds the names it is meant to hold: functions, methods,
    ``__call__``, class aliases, dataclass fields, constants, ``__all__``
    entries; a name dropped from the port would show."""
    names = public_names(JAX_MODULES["channels"], defined_only=True)
    for n in ("compute_pyramid", "default_channel_opts",
              "ChannelFunction.fn", "ChannelFunction.__call__",
              "ChannelFunction.n_channels", "Level.scale"):
        assert n in names, n
    assert "Boxes.add_field" in public_names(JAX_MODULES["boxes"],
                                             defined_only=True)
    assert "PackedPyramidPlan.level_interior_mask" in public_names(
        JAX_MODULES["packing"], defined_only=True)
    port = public_names(PORT_MODULES["channels"], defined_only=False)
    assert "ChannelFunction.fn" in port and "compute_pyramid" in port
    assert ("ops.image", "*") not in missing_from_port()
