"""Generate the TS SDK's wire types from the port's API models
(`smelter_tpu_torch/api/schema.py`), the counterpart of the reference's
`tools/generate_ts_types.py`. The port's models are the reference's, so
the output is byte-equal to the committed `ts/smelter/src/api.generated.ts`
(its header names the reference's generator, which wrote that file).

Usage: python -m smelter_tpu_torch.tools.generate_ts_types [outfile=generated/ts/api.generated.ts]

The default file is git-ignored; `ts/smelter/src/` holds the reference's
file and is never written here unless asked for.
"""

from __future__ import annotations

import os
import sys
import typing
from typing import get_args, get_origin

import pydantic

from smelter_tpu_torch.api import schema as api

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "generated", "ts", "api.generated.ts")  # git-ignored

HEADER = """\
// GENERATED FILE — do not edit.
// Produced by tools/generate_ts_types.py from smelter_tpu/api/schema.py
// (the exact models the server validates requests against), mirroring the
// reference's api.generated.ts codegen pipeline.

export type ComponentId = string;
export type RendererId = string;
export type OutputId = string;
export type InputId = string;
"""

# Union aliases exported by name (order matters for readability)
UNION_ALIASES = [
    "EasingFunction",
    "ShaderParam",
    "Component",
    "VideoEncoderOptions",
    "AudioEncoderOptions",
    "WhipVideoEncoderPreference",
    "WhipAudioEncoderPreference",
    "RegisterOutput",
    "RegisterInput",
]


def _is_model(tp) -> bool:
    return isinstance(tp, type) and issubclass(tp, pydantic.BaseModel)


class Generator:
    def __init__(self) -> None:
        self.emitted: dict = {}
        self.order: list = []

    def ts_type(self, tp) -> str:
        origin = get_origin(tp)
        if tp is type(None):
            return "null"
        if tp is str:
            return "string"
        if tp in (int, float):
            return "number"
        if tp is bool:
            return "boolean"
        if tp is object or tp is typing.Any:
            return "unknown"
        if _is_model(tp):
            self.emit_model(tp)
            return tp.__name__
        if origin is typing.Literal:
            return " | ".join(
                f'"{v}"' if isinstance(v, str) else str(v) for v in get_args(tp)
            )
        if origin in (list, typing.List):
            inner = self.ts_type(get_args(tp)[0])
            return f"({inner})[]" if "|" in inner else f"{inner}[]"
        if origin in (tuple, typing.Tuple):
            args = get_args(tp)
            if len(args) == 2 and args[1] is Ellipsis:
                return f"{self.ts_type(args[0])}[]"
            return "[" + ", ".join(self.ts_type(a) for a in args) + "]"
        if origin in (dict, typing.Dict):
            k, v = get_args(tp)
            return f"Record<{self.ts_type(k)}, {self.ts_type(v)}>"
        if origin is typing.Union:
            args = [a for a in get_args(tp) if a is not type(None)]
            parts = sorted({self.ts_type(a) for a in args})
            return " | ".join(parts)
        # Annotated[...] (discriminated unions)
        if hasattr(tp, "__metadata__"):
            return self.ts_type(get_args(tp)[0])
        if isinstance(tp, str):  # forward ref left unresolved
            return tp
        if isinstance(tp, typing.ForwardRef):
            return tp.__forward_arg__
        raise TypeError(f"cannot map {tp!r} to TypeScript")

    def emit_model(self, model) -> None:
        name = model.__name__
        if name in self.emitted:
            return
        self.emitted[name] = ""  # cycle guard
        lines = [f"export interface {name} {{"]
        hints = typing.get_type_hints(model, vars(api))
        for fname, field in model.model_fields.items():
            tp = hints.get(fname, field.annotation)
            optional = not field.is_required()
            base = tp
            if get_origin(tp) is typing.Union and type(None) in get_args(tp):
                optional = True
            ts = self.ts_type(base)
            ts = ts.replace(" | null", "") if ts.endswith(" | null") else ts
            opt = "?" if optional else ""
            lines.append(f"  {fname}{opt}: {ts};")
        lines.append("}")
        self.emitted[name] = "\n".join(lines)
        self.order.append(name)

    def emit_alias(self, name: str) -> str:
        alias = getattr(api, name)
        return f"export type {name} = {self.ts_type(alias)};"


def main() -> None:
    out = (
        sys.argv[1]
        if len(sys.argv) > 1
        else DEFAULT_OUT
    )
    gen = Generator()

    # roots: everything reachable from the public request surface
    roots = [
        api.UpdateOutputRequest,
        api.ShaderSpec,
        api.ImageSpec,
        api.WebRendererSpec,
        api.FontSpec,
    ]
    alias_lines = []
    for alias in UNION_ALIASES:
        alias_lines.append(gen.emit_alias(alias))
    for model in roots:
        gen.emit_model(model)

    body = "\n\n".join(gen.emitted[n] for n in gen.order)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(HEADER + "\n" + body + "\n\n" + "\n".join(alias_lines) + "\n")
    print(f"wrote {out} ({len(gen.order)} interfaces, {len(alias_lines)} aliases)")


if __name__ == "__main__":
    main()
