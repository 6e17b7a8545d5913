"""Registration-time validation + sandboxed execution for user shaders, a
copy of `smelter_tpu/render/shader_validation.py` whose shaders run on torch.

The reference's WGSL shaders (`smelter-render/src/transformations/shader/
validation.rs`) are verified at registration, so bad shaders fail the
register call, not the first frame, and cannot touch the host. Here the
shader language is the restricted Python/JAX subset of the wire contract,
and both properties are enforced explicitly, with the reference's rules and
error texts:

1. **AST allowlist** (`validate_source`), verbatim: function defs,
   arithmetic, indexing, calls, comprehensions, conditionals and loops;
   `import`, `class`, `try`, `with`, `global`/`nonlocal`, any identifier or
   attribute starting with an underscore, and host-IO attribute names are
   rejected with the offending line number.
2. **Closed builtins** (`SAFE_BUILTINS`), verbatim.
3. **Trace** (`validate_traced`): `main` runs at registration on tensors of
   the "meta" device (shapes and types, no data, no compute), where the
   reference runs `jax.eval_shape`. A wrong signature, a raise, an unknown
   ``jnp``/``lax`` name, a branch on a traced value, or an output that is
   not one ``(resolution.h, resolution.w, 4)`` floating array is rejected.

``jnp`` and ``lax`` are the port's own torch-backed namespace
(`render/shader_ns.py`, which lists the covered names), built for one
device: `compile_sandboxed` binds the namespace it is given.
"""

from __future__ import annotations

import ast
import math
from typing import Callable, Optional

import torch

from smelter_tpu_torch.render.shader_ns import ShaderArray, ShaderNamespace


class ShaderValidationError(ValueError):
    """Raised for any rejected shader registration (maps to HTTP 400)."""


# Node classes a shader module may contain. Notably absent: Import,
# ImportFrom, ClassDef, Try, With, Raise, Assert, Global, Nonlocal,
# Delete, Await/Async*, Yield*, NamedExpr is allowed (harmless).
_ALLOWED_NODES = (
    ast.Module,
    ast.FunctionDef,
    ast.arguments,
    ast.arg,
    ast.Return,
    ast.Assign,
    ast.AugAssign,
    ast.AnnAssign,
    ast.NamedExpr,
    ast.Expr,
    ast.If,
    ast.For,
    ast.While,
    ast.Break,
    ast.Continue,
    ast.Pass,
    ast.BoolOp,
    ast.BinOp,
    ast.UnaryOp,
    ast.Compare,
    ast.Call,
    ast.keyword,
    ast.IfExp,
    ast.Attribute,
    ast.Subscript,
    ast.Slice,
    ast.Tuple,
    ast.List,
    ast.Dict,
    ast.Set,
    ast.Name,
    ast.Constant,
    ast.ListComp,
    ast.GeneratorExp,
    ast.DictComp,
    ast.comprehension,
    ast.Lambda,
    ast.Starred,
    ast.JoinedStr,
    ast.FormattedValue,
    ast.operator,
    ast.unaryop,
    ast.cmpop,
    ast.boolop,
    ast.expr_context,
)

# Attribute/identifier names that reach host state through the modules we
# expose (numpy/jax file IO, codegen, attribute reflection).
_DENIED_NAMES = frozenset(
    {
        "load", "loads", "save", "savez", "savez_compressed", "loadtxt",
        "savetxt", "genfromtxt", "fromfile", "tofile", "memmap", "open",
        "open_memmap", "DataSource", "lib", "ctypeslib", "require",
        "eval", "exec", "compile", "getattr", "setattr", "delattr",
        "vars", "globals", "locals", "breakpoint", "input", "type",
        "object", "super", "callback", "pure_callback", "io_callback",
        "debug_callback", "effects_barrier", "profiler",
    }
)

SAFE_BUILTINS = {
    name: b
    for name, b in (
        ("len", len), ("range", range), ("min", min), ("max", max),
        ("abs", abs), ("sum", sum), ("enumerate", enumerate), ("zip", zip),
        ("float", float), ("int", int), ("bool", bool), ("tuple", tuple),
        ("list", list), ("dict", dict), ("set", set), ("round", round),
        ("sorted", sorted), ("reversed", reversed), ("map", map),
        ("filter", filter), ("any", any), ("all", all), ("divmod", divmod),
        ("isinstance", isinstance), ("print", print),
        ("True", True), ("False", False), ("None", None),
        ("ValueError", ValueError),
    )
}


def validate_source(shader_id: str, source: str) -> ast.Module:
    """Parse and allowlist-check a shader source; returns the AST."""
    try:
        tree = ast.parse(source, filename=f"<shader:{shader_id}>")
    except SyntaxError as exc:
        raise ShaderValidationError(
            f"shader {shader_id!r}: syntax error at line {exc.lineno}: {exc.msg}"
        ) from None
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ShaderValidationError(
                f"shader {shader_id!r}: {type(node).__name__} is not allowed "
                f"in shader source (line {getattr(node, 'lineno', '?')}) — "
                "shaders are a restricted JAX subset: functions, arithmetic, "
                "indexing, jnp/lax/math calls"
            )
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, (ast.FunctionDef, ast.arg)):
            name = node.name if isinstance(node, ast.FunctionDef) else node.arg
        elif isinstance(node, ast.keyword):
            name = node.arg
        if name is None:
            continue
        if name.startswith("_"):
            raise ShaderValidationError(
                f"shader {shader_id!r}: name {name!r} is not allowed "
                f"(line {getattr(node, 'lineno', '?')}): underscore-prefixed "
                "names (including dunders) are blocked in shader source"
            )
        if name in _DENIED_NAMES:
            raise ShaderValidationError(
                f"shader {shader_id!r}: {name!r} is not allowed in shader "
                f"source (line {getattr(node, 'lineno', '?')})"
            )
    return tree


def compile_sandboxed(shader_id: str, source: str,
                      jnp: Optional[ShaderNamespace] = None) -> Callable:
    """Validate + execute the module body in a sandboxed namespace and
    return its ``main``. The namespace exposes only jnp / lax / math and
    the SAFE_BUILTINS allowlist; ``jnp`` is the given `ShaderNamespace` (a
    CPU one when None), ``lax`` its `lax`."""
    tree = validate_source(shader_id, source)
    if jnp is None:
        jnp = ShaderNamespace("cpu")
    namespace = {
        "__builtins__": dict(SAFE_BUILTINS),
        "jnp": jnp,
        "lax": jnp.lax,
        "math": math,
    }
    exec(  # noqa: S102 — source passed the AST allowlist above
        compile(tree, f"<shader:{shader_id}>", "exec"), namespace
    )
    fn = namespace.get("main")
    if not callable(fn):
        raise ShaderValidationError(
            f"shader {shader_id!r} must define "
            "main(inputs, params, resolution, time)"
        )
    return fn


class _AbstractParam(float):
    """Permissive stand-in for ``params`` during registration tracing.

    Shader params are STATIC Python values at trace time (the frame program
    passes the API's shader_param object straight into ``main``), so the
    proxy is a float subclass — arithmetic and jnp calls treat it as 1.0 —
    that also answers mapping-style lookups with more of itself, covering
    ``params["gain"]``, ``params.get(...)``, and nested dicts without
    knowing the real param schema."""

    def __new__(cls):
        return super().__new__(cls, 1.0)

    def __getitem__(self, key):
        return _AbstractParam()

    def get(self, key, default=None):
        return _AbstractParam()

    def __iter__(self):
        return iter((_AbstractParam(),))

    def __len__(self):
        return 1


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for x in out for leaf in _leaves(x)]
    if isinstance(out, dict):
        return [leaf for x in out.values() for leaf in _leaves(x)]
    return [] if out is None else [out]


def validate_traced(
    shader_id: str, fn: Callable, max_textures: int
) -> None:
    """Run ``main`` at registration on "meta" tensors (shapes and types
    only; `fn` compiled against a "meta" `ShaderNamespace`) and reject wrong
    signatures / output contracts, mirroring validation.rs's register-time
    failure semantics with the reference's messages."""
    res_w, res_h = 64, 48
    inputs = [
        ShaderArray(torch.empty((res_h, res_w, 4), dtype=torch.float32, device="meta"))
        for _ in range(min(2, max_textures))
    ]
    time = ShaderArray(torch.empty((), dtype=torch.float32, device="meta"))
    try:
        out = fn(list(inputs), _AbstractParam(), (res_w, res_h), time)
    except ShaderValidationError:
        raise
    except Exception as exc:
        raise ShaderValidationError(
            f"shader {shader_id!r} failed abstract tracing with "
            f"{len(inputs)} input textures at {res_w}x{res_h}: "
            f"{type(exc).__name__}: {exc}"
        ) from None
    leaves = _leaves(out)
    if len(leaves) != 1:
        raise ShaderValidationError(
            f"shader {shader_id!r} main must return a single array, got "
            f"{len(leaves)} outputs"
        )
    leaf = leaves[0]
    t = leaf.t if isinstance(leaf, ShaderArray) else torch.as_tensor(leaf)
    shape, dtype = tuple(t.shape), t.dtype
    if shape != (res_h, res_w, 4):
        raise ShaderValidationError(
            f"shader {shader_id!r} main returned shape {shape} for "
            f"resolution ({res_w}, {res_h}); the contract is "
            "(resolution.height, resolution.width, 4)"
        )
    if not dtype.is_floating_point:
        raise ShaderValidationError(
            f"shader {shader_id!r} main returned dtype "
            f"{str(dtype).replace('torch.', '')}; the "
            "contract is a floating-point RGBA image"
        )
