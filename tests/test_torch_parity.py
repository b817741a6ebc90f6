"""Name parity: every public name of the JAX package has a counterpart of
the same name in the PyTorch port.

Both packages are read with ``ast`` and neither is imported, so the check
is cheap and compiles nothing. For each module of ``tuturenderer_tpu/``
it collects the public top-level functions, classes and constants, and
each class's public methods, properties, fields (``NamedTuple`` and
dataclass) and class attributes; a package's ``__init__.py`` also counts
the names it re-exports. A public name starts with no underscore, or is a
dunder. The port's counterpart module (the same path, or the modules
``MOVED`` names) must bind each one: by a definition, or by an import of
the same name, which is how a port module shares one quantity with
another (``PI`` of ``materials.py`` in ``integrators/bdpt.py`` and
``ops/lights.py``, ``CHUNK`` of ``ops/cuda/intersect.py`` in
``ops/intersect.py``).

``ALLOWED`` lists the names the port leaves out on purpose: exactly
ROADMAP.md's "Do not port" items, each with its reason. An entry that the
port does bind fails the check as well, so the list cannot go stale.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "tuturenderer_tpu")
PORT_PKG = os.path.join(ROOT, "tuturenderer_tpu_torch")

# modules the port moved: the JAX module -> the port modules that hold its
# names between them, and the names the port renamed (JAX name -> port
# name). The Pallas kernels' wrappers became the CUDA kernels' wrappers in
# ops/cuda/ (the table packers and constants with them); the cluster
# tables' host build went to ops/cluster.py.
MOVED = {
    "ops/pallas/__init__.py": (("ops/cuda/__init__.py",), {}),
    "ops/pallas/intersect.py": (
        ("ops/cuda/intersect.py", "ops/intersect.py"),
        {"pallas_tri_intersect": "tri_intersect",
         "pallas_tri_occluded": "tri_occluded",
         "PALLAS_IMPL": "DENSE_KERNEL"}),
    "ops/pallas/cluster.py": (("ops/cluster.py", "ops/cuda/cluster.py"), {}),
}

_TILES = ("a TPU tile mechanism (the 1024-lane tiles, the visit lists and "
          "their DMA groups); the CUDA kernels trace per ray")
_SORT = ("the octant-Morton wavefront sort: the port traces in the caller's "
         "order until the port's bench shows a sort pays on the H100")

# (JAX module, name) -> why the port has no counterpart; a name of None
# stands for the whole module
ALLOWED = {
    ("ops/bvh.py", None): "the XLA BVH; the port's CPU route is the "
                          "kernels' plain versions",
    ("scene/data.py", "SceneData.bvh"): "the XLA BVH's tables (ops/bvh.py)",
    ("ops/intersect.py", "DENSE_IMPL"): "selects _tri_chunk_best_woop, the "
                                        "XLA matmul chunk; the port's form "
                                        "switch is DENSE_KERNEL",
    ("utils/vec.py", "Array"): "a JAX type alias (jnp.ndarray)",
    ("utils/vec.py", "Scalar"): "a JAX type alias (float or jnp.ndarray)",
    ("utils/rng.py", "U32"): "jnp.uint32: PyTorch has no full uint32 "
                             "arithmetic, so the port holds the words in "
                             "int64 reduced by MASK",
    ("ops/pallas/intersect.py", "LANES"): _TILES,
    ("ops/pallas/intersect.py", "ROWS"): _TILES,
    ("ops/pallas/intersect.py", "UNROLL_MAX"): _TILES,
    ("ops/pallas/intersect.py", "STRANDS"): _TILES,
    ("ops/pallas/cluster.py", "ROWS"): _TILES,
    ("ops/pallas/cluster.py", "G"): _TILES,
    ("ops/pallas/cluster.py", "SENTINEL"): _TILES,
    ("ops/pallas/cluster.py", "ray_sort_keys"): _SORT,
    ("ops/pallas/cluster.py", "sorted_ray_order"): _SORT,
}


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _targets(node):
    """The names an assignment binds."""
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def _class_members(node: ast.ClassDef):
    for b in node.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield b.name
        elif isinstance(b, (ast.Assign, ast.AnnAssign)):
            yield from _targets(b)


def module_names(path: str, imports: bool) -> set:
    """Public names a module binds at its top level (classes as ``Class``
    and ``Class.member``); with ``imports``, the names its imports bind
    too."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{m}" for m in _class_members(node)
                       if _public(m))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if all(_public(p) for p in n.split("."))}


def jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), JAX_PKG))
    return sorted(m.replace(os.sep, "/") for m in out)


def missing_names(module: str) -> set:
    """Public names of a JAX module that its port counterparts do not
    bind, after the renames of MOVED."""
    if (module, None) in ALLOWED:
        return set()
    targets, renames = MOVED.get(module, ((module,), {}))
    ported = set()
    for target in targets:
        path = os.path.join(PORT_PKG, target)
        assert os.path.exists(path), f"{module}: no port module {target}"
        ported |= module_names(path, imports=True)
    # a package's __init__ re-exports are public names of the package
    wanted = module_names(os.path.join(JAX_PKG, module),
                          imports=module.endswith("__init__.py"))
    return {n for n in wanted
            if renames.get(n.split(".")[0], n.split(".")[0])
            + n[len(n.split(".")[0]):] not in ported}


@pytest.mark.parametrize("module", jax_modules())
def test_every_public_name_has_a_port(module):
    missing = {n for n in missing_names(module)
               if (module, n) not in ALLOWED}
    assert not missing, (f"tuturenderer_tpu/{module}: no counterpart in the "
                         f"port for {sorted(missing)}")


def test_allowlist_names_only_what_the_port_leaves_out():
    modules = set(jax_modules())
    for (module, name), reason in ALLOWED.items():
        assert module in modules, f"{module} is no module of the JAX package"
        assert reason
        if name is None:
            assert not os.path.exists(os.path.join(PORT_PKG, module)), module
            continue
        wanted = module_names(os.path.join(JAX_PKG, module), imports=False)
        assert name in wanted, f"{module}: {name} is no public JAX name"
        assert name in missing_names(module), \
            f"{module}: the port binds {name}; drop it from ALLOWED"


def test_moved_modules_have_no_namesake_in_the_port():
    for module, (targets, renames) in MOVED.items():
        assert not os.path.exists(os.path.join(PORT_PKG, module)), module
        for target in targets:
            assert os.path.exists(os.path.join(PORT_PKG, target)), target
        wanted = module_names(os.path.join(JAX_PKG, module), imports=False)
        assert set(renames) <= wanted, module


def test_collector_sees_every_kind_of_name(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "from typing import NamedTuple\n"
        "import os.path\n"
        "from x import y as z\n"
        "A = 1\n"
        "B: int = 2\n"
        "C, (D, _E) = 3, (4, 5)\n"
        "_F = 6\n"
        "__all__ = ['A']\n"
        "def f(): pass\n"
        "def _g(): pass\n"
        "class K(NamedTuple):\n"
        "    x: int\n"
        "    _y: int = 0\n"
        "    W = 1\n"
        "    def m(self): pass\n"
        "    def _p(self): pass\n"
        "    def __add__(self, o): pass\n"
        "    @property\n"
        "    def q(self): return 1\n"
        "class _H:\n"
        "    def m(self): pass\n")
    defined = {"A", "B", "C", "D", "__all__", "f", "K", "K.x", "K.W", "K.m",
               "K.__add__", "K.q"}
    assert module_names(str(src), imports=False) == defined
    assert module_names(str(src), imports=True) == \
        defined | {"NamedTuple", "os", "z"}
