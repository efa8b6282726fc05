"""Generate docs/api_reference.md — the per-symbol API reference.

Doc parity with the reference's Doxygen (every entry point, enum, and
struct field documented, /root/reference/api/rocjpeg.h:40-343): the Python
reference is generated from live docstrings and signatures so it cannot
drift silently, and the C ABI chapter is extracted from the documented
header (include/rocjpeg_tpu.h). tests/test_docs.py asserts that every
public symbol carries a docstring and appears in the generated file.

Usage: python tools/gen_api_doc.py   (writes docs/api_reference.md)
"""

import dataclasses
import enum
import inspect
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def public_names(mod):
    names = getattr(mod, "__all__", None)
    if names:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", None)
            == mod.__name__]


def indent_doc(doc):
    return inspect.cleandoc(doc or "*(undocumented)*")


def fmt_signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def emit_enum(out, cls):
    out.append(f"### enum `{cls.__name__}`\n")
    out.append(indent_doc(cls.__doc__) + "\n")
    out.append("| member | value |")
    out.append("|---|---|")
    for m in cls:
        out.append(f"| `{m.name}` | {m.value} |")
    out.append("")


def emit_dataclass(out, cls):
    out.append(f"### class `{cls.__name__}`\n")
    out.append(indent_doc(cls.__doc__) + "\n")
    fields = dataclasses.fields(cls)
    if fields:
        out.append("| field | type | default |")
        out.append("|---|---|---|")
        for f in fields:
            t = getattr(f.type, "__name__", str(f.type))
            if f.default is not dataclasses.MISSING:
                d = f"`{f.default!r}`"
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                d = f"`{f.default_factory.__name__}()`"
            else:
                d = "required"
            out.append(f"| `{f.name}` | `{t}` | {d} |")
        out.append("")
    emit_methods(out, cls, heading="####")


def emit_methods(out, cls, heading="###"):
    for name, member in sorted(vars(cls).items()):
        if name.startswith("_") and name != "__init__":
            continue
        if isinstance(member, property):
            out.append(f"{heading} property `{cls.__name__}.{name}`\n")
            out.append(indent_doc(member.fget.__doc__) + "\n")
        elif isinstance(member, (staticmethod, classmethod)):
            fn = member.__func__
            out.append(f"{heading} `{cls.__name__}.{name}{fmt_signature(fn)}`\n")
            out.append(indent_doc(fn.__doc__) + "\n")
        elif inspect.isfunction(member):
            if name == "__init__" and not member.__doc__:
                continue  # construction is covered by the class docstring
            label = f"{cls.__name__}" if name == "__init__" \
                else f"{cls.__name__}.{name}"
            out.append(f"{heading} `{label}{fmt_signature(member)}`\n")
            out.append(indent_doc(member.__doc__) + "\n")


def emit_class(out, cls):
    out.append(f"### class `{cls.__name__}`\n")
    out.append(indent_doc(cls.__doc__) + "\n")
    emit_methods(out, cls, heading="####")


def emit_module(out, mod, title, only=None):
    out.append(f"## {title}\n")
    doc = inspect.cleandoc(mod.__doc__ or "")
    if doc:
        out.append(doc + "\n")
    for name in (only or public_names(mod)):
        obj = getattr(mod, name)
        if isinstance(obj, type) and issubclass(obj, enum.Enum):
            emit_enum(out, obj)
        elif dataclasses.is_dataclass(obj):
            emit_dataclass(out, obj)
        elif inspect.isclass(obj):
            emit_class(out, obj)
        elif inspect.isfunction(obj):
            out.append(f"### `{mod.__name__.split('.')[-1]}."
                       f"{name}{fmt_signature(obj)}`\n")
            out.append(indent_doc(obj.__doc__) + "\n")
        else:
            out.append(f"### `{name}`\n")
            out.append(f"`{name} = {obj!r}`\n")
    out.append("")


def emit_c_header(out):
    """Extract (comment, declaration) pairs from include/rocjpeg_tpu.h."""
    path = os.path.join(ROOT, "include", "rocjpeg_tpu.h")
    src = open(path).read()
    out.append("## C ABI (`include/rocjpeg_tpu.h`)\n")
    out.append("Drop-in C ABI; same nine entry points, enum values, and "
               "struct layouts as the reference `api/rocjpeg.h:204-343`. "
               "Every declaration below is documented in the header "
               "itself; this chapter is extracted from it verbatim.\n")
    # Match block comments followed by a declaration (typedef/struct/enum/
    # function prototype) up to the closing semicolon.
    pat = re.compile(r"/\*(.*?)\*/\s*\n((?:[^/;{]|\{[^}]*\})*?;)", re.S)
    for m in pat.finditer(src):
        comment = "\n".join(line.strip(" *") for line in
                            m.group(1).strip().splitlines()).strip()
        decl = m.group(2).strip()
        if decl.startswith("#"):
            continue
        out.append(f"```c\n{decl}\n```")
        out.append(comment + "\n")
    out.append("")


def main():
    from rocjpeg_tpu import api, capi, status, types

    out = [
        "# rocjpeg_tpu API reference",
        "",
        "*Generated by `tools/gen_api_doc.py` from live docstrings — do "
        "not edit by hand; regenerate after API changes (asserted by "
        "`tests/test_docs.py`).*",
        "",
        "Reference parity: every entry point, enum, and struct of the "
        "rocJPEG C API (`/root/reference/api/rocjpeg.h:40-343`) has a "
        "documented equivalent here; see `docs/api.md` for the mapping "
        "table and `PARITY.md` for the component map.",
        "",
    ]
    emit_module(out, api, "Session API (`rocjpeg_tpu.api`)",
                only=["JpegStream", "Decoder", "write_channel_into"])
    emit_module(out, types, "Types (`rocjpeg_tpu.types`)",
                only=["ChromaSubsampling", "OutputFormat", "Backend",
                      "CropRectangle", "DecodeParams", "DecodedImage",
                      "LazyChannel", "ImageInfo", "TpuDecodeSpec",
                      "spec_for_device"])
    emit_module(out, status, "Status codes (`rocjpeg_tpu.status`)",
                only=["Status", "RocJpegError", "get_error_name"])
    emit_module(out, capi, "C-style functional API (`rocjpeg_tpu.capi`)")
    emit_c_header(out)

    dest = os.path.join(ROOT, "docs", "api_reference.md")
    with open(dest, "w") as f:
        f.write("\n".join(out).rstrip() + "\n")
    print(f"wrote {dest} ({len(out)} blocks)")


if __name__ == "__main__":
    main()
