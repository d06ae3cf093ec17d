"""Every public name of `repro` has a counterpart of the same name in the port.

An AST walk over the source files of both packages (neither is imported,
so no JAX is loaded): for each module under ``src/repro/``, its
counterpart of the same path under ``src/repro_torch/`` (`COUNTERPART`
names the one module whose counterpart has another name) must define
every public top-level function, class and constant, every public
method of a public class (as ``Class.method``), every name a module's
``__all__`` lists, and every name a package ``__init__`` imports.

The exceptions are `ALLOWLIST`: names that belong to JAX or the TPU,
each with its reason.  An allowlisted name is also excused where a
reference module re-exports it.  The allowlist is held exact: an entry
whose name the reference no longer has, or the port now has, fails too.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

# reference module -> the port's module that stands for it
COUNTERPART = {"roofline/hlo_analysis.py": "roofline/op_analysis.py"}

_HLO = ("reads XLA's HLO text; the port counts operators as they run "
        "(`OpCounter`)")

ALLOWLIST = {
    ("kernels/runtime.py", "default_interpret"):
        "Pallas interpret mode on a host without a TPU; the port picks a "
        "device (`resolve_device`)",
    ("kernels/runtime.py", "resolve_interpret"):
        "resolves a kernel's ``interpret=`` argument; the port has none",
    ("kernels/runtime.py", "default_lane"):
        "the host's Pallas/XLA lowering lane (mosaic, triton, xla); the "
        "port has one CUDA route",
    ("kernels/runtime.py", "resolve_lane"):
        "resolves a ``compiled=`` lane name; the port has no lanes",
    ("kernels/runtime.py", "COMPILED_MERGE_CANDIDATES"):
        "merge depths priced for the compiled XLA lanes; the port's planner "
        "prices its CUDA kernels",
    ("kernels/blmac_fir.py", "LANES"):
        "the names of the reference's Pallas/XLA lowering lanes",
    ("distributed/collectives.py", "get_shard_map"):
        "finds `jax.shard_map` across JAX versions",
    ("distributed/collectives.py", "shard_map_no_check_kwargs"):
        "the replication-check keyword of this JAX's `shard_map`",
    ("launch/mesh.py", "ICI_BW"):
        "the TPU's inter-chip link rate; the port's is `NVLINK_BW`",
    ("launch/train.py", "TPU_PERF_FLAGS"):
        "libtpu/XLA flags for the TPU's collectives",
    ("launch/dryrun.py", "lower_cell"):
        "lowers a cell with `jax.jit` to HLO; the port traces it on meta "
        "slots (`trace_cell`)",
    ("nn/common.py", "Pytree"):
        "the JAX pytree type alias; the port's params are dicts of tensors",
    ("nn/common.py", "ShardCtx.shard"):
        "`with_sharding_constraint` on a JAX array; the port places "
        "pieces with `distributed.placement`",
    ("roofline/hlo_analysis.py", "shape_bytes"): _HLO,
    ("roofline/hlo_analysis.py", "shape_dims"): _HLO,
    ("roofline/hlo_analysis.py", "OpDef"): _HLO,
    ("roofline/hlo_analysis.py", "parse_def"): _HLO,
    ("roofline/hlo_analysis.py", "split_computations"): _HLO,
    ("roofline/hlo_analysis.py", "analyze_hlo"): _HLO,
}

REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _bound_names(target) -> list:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    return []  # an attribute or item store binds no module name


def _walk(path: pathlib.Path) -> tuple[set, set]:
    """(names the module offers, names bound at its top level).

    Offered: public functions, classes, their public methods, constants,
    ``__all__``'s entries and, in a package ``__init__``, what it
    imports.  Bound: what a definition, assignment or import binds (a
    name ``__all__`` lists is not thereby bound)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defined, listed, imported = set(), set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined.add(node.name)
        elif isinstance(node, ast.ClassDef):
            defined.add(node.name)
            defined.update(
                f"{node.name}.{b.name}" for b in node.body
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    listed.update(e.value for e in node.value.elts)
                else:
                    defined.update(_bound_names(t))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0]
                            for a in node.names)
    offered = defined | listed
    if path.name == "__init__.py":
        offered |= imported
    return ({n for n in offered if all(map(_public, n.split(".")))},
            defined | imported)


def _counterpart(rel: str) -> pathlib.Path:
    return PORT / COUNTERPART.get(rel, rel)


def _missing(rel: str) -> set:
    """Names of reference module ``rel`` its counterpart lacks, less the
    allowlist (and its re-exports)."""
    ref_names, ref_bound = _walk(REF / rel)
    _, port_bound = _walk(_counterpart(rel))
    excused = {n for (_, n) in ALLOWLIST}
    return {n for n in ref_names - port_bound
            if (rel, n) not in ALLOWLIST
            and not (n in ref_bound and n in excused)}


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_has_counterpart_with_every_public_name(rel):
    assert _counterpart(rel).is_file(), (
        f"src/repro/{rel} has no counterpart in src/repro_torch/")
    missing = sorted(_missing(rel))
    assert not missing, (
        f"src/repro_torch/{COUNTERPART.get(rel, rel)} lacks {missing} of "
        f"src/repro/{rel}")


@pytest.mark.parametrize("entry", sorted(ALLOWLIST), ids="::".join)
def test_allowlist_entry_is_a_real_gap(entry):
    """Each allowlisted name exists in the reference and not in the port,
    and carries a reason."""
    rel, name = entry
    assert ALLOWLIST[entry].strip()
    assert name in _walk(REF / rel)[0], f"src/repro/{rel} has no {name}"
    assert name not in _walk(_counterpart(rel))[1], (
        f"the port now has {name}: drop it from the allowlist")


def test_walk_sees_functions_methods_constants_and_reexports():
    """The walk itself: it must find each kind of name it checks."""
    offered, bound = _walk(PORT / "compiler" / "program.py")
    assert {"pack_bank_trits", "BlmacProgram", "BlmacProgram.schedule",
            "PROGRAM_FORMAT_VERSION"} <= offered & bound
    assert "_bank_digits" in bound and "_bank_digits" not in offered
    offered, _ = _walk(PORT / "kernels" / "__init__.py")
    assert {"pack_bank_trits", "BankSchedule", "superlayer_schedule"} <= offered
    assert "SPECIALIZE_THRESHOLD" in _walk(PORT / "filters" / "bank.py")[0]
    assert "ShardCtx.shard" in _walk(REF / "nn" / "common.py")[0]
    offered, bound = _walk(REF / "kernels" / "ops.py")
    assert "pulse_quantize" in offered and "np" in bound - offered
    assert "os" not in _walk(REF / "launch" / "dryrun.py")[0]
    assert len(REF_MODULES) > 50
