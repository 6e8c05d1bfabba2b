#!/usr/bin/env python3
"""API documentation generator (the reference's Doxygen analogue).

The reference ships a full Doxygen setup (``/root/reference/Doxyfile``,
``Makefile:70-71``: EXTRACT_ALL over src/ + include/ into build/docs).  This
environment has neither doxygen, pdoc nor sphinx, so this is a dependency-free
equivalent: it imports every module of ``raymarchdenoiser``, extracts
the public API (classes, functions, dataclasses, signatures, docstrings) via
``inspect``, and emits one HTML page per module plus a cross-linked index
into ``build/docs``.  Import errors are build failures (exit 1), not warnings
— unlike the round-1 ``pydoc ... || true`` target this actually validates the
package surface.

Usage: python tools/gendocs.py [--out build/docs]
"""

from __future__ import annotations

import argparse
import dataclasses
import html
import importlib
import inspect
import os
import pkgutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACKAGE = "raymarchdenoiser"

_CSS = """
body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 2em auto;
       max-width: 60em; color: #1a1a2e; line-height: 1.45; }
h1 { border-bottom: 2px solid #4a4e8f; padding-bottom: .2em; }
h2 { color: #33366e; margin-top: 1.6em; }
code, pre { font-family: ui-monospace, Menlo, monospace; font-size: .92em; }
pre.doc { background: #f4f5fa; border-left: 3px solid #8a8fd0;
          padding: .7em 1em; white-space: pre-wrap; }
.sig { background: #eceefc; padding: .35em .6em; border-radius: 4px;
       display: block; margin-top: 1em; }
.kind { color: #7a7ca8; font-size: .85em; margin-right: .5em; }
a { color: #3a3e9f; text-decoration: none; }
a:hover { text-decoration: underline; }
table { border-collapse: collapse; }
td, th { border: 1px solid #ccd; padding: .3em .7em; text-align: left; }
"""


def _esc(s):
    return html.escape(s if s else "")


def _doc_html(obj) -> str:
    doc = inspect.getdoc(obj)
    return f'<pre class="doc">{_esc(doc)}</pre>' if doc else ""


def _sig(obj) -> str:
    try:
        return _esc(str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(…)"


def _document_class(name, cls, mod_name):
    parts = [f'<h3 id="{name}"><span class="kind">class</span>'
             f'<code>{name}</code></h3>', _doc_html(cls)]
    if dataclasses.is_dataclass(cls):
        rows = "".join(
            f"<tr><td><code>{_esc(f.name)}</code></td>"
            f"<td><code>{_esc(getattr(f.type, '__name__', str(f.type)))}"
            f"</code></td><td><code>"
            f"{_esc(repr(f.default) if f.default is not dataclasses.MISSING else '—')}"
            f"</code></td></tr>"
            for f in dataclasses.fields(cls))
        parts.append("<table><tr><th>field</th><th>type</th>"
                     f"<th>default</th></tr>{rows}</table>")
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_") or not callable(m):
            continue
        if inspect.isfunction(m):
            parts.append(
                f'<code class="sig">{name}.{mname}{_sig(m)}</code>'
                + _doc_html(m))
    return "\n".join(parts)


def _document_module(mod_name: str, out_dir: str) -> dict:
    mod = importlib.import_module(mod_name)
    entries = []
    body = [f"<h1><code>{mod_name}</code></h1>", _doc_html(mod)]
    members = sorted(vars(mod).items())
    funcs, classes = [], []
    for name, obj in members:
        if name.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != mod_name:
            continue  # re-exports documented at their home module
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            funcs.append((name, obj))
    if classes:
        body.append("<h2>Classes</h2>")
        for name, obj in classes:
            body.append(_document_class(name, obj, mod_name))
            entries.append((mod_name, name, "class"))
    if funcs:
        body.append("<h2>Functions</h2>")
        for name, obj in funcs:
            body.append(f'<h3 id="{name}"><span class="kind">def</span>'
                        f'<code>{name}</code></h3>'
                        f'<code class="sig">{name}{_sig(obj)}</code>'
                        + _doc_html(obj))
            entries.append((mod_name, name, "function"))
    page = (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{mod_name}</title><style>{_CSS}</style></head><body>"
            f"<p><a href='index.html'>&larr; index</a></p>"
            + "\n".join(body) + "</body></html>")
    fname = mod_name.replace(".", "_") + ".html"
    with open(os.path.join(out_dir, fname), "w") as f:
        f.write(page)
    return {"module": mod_name, "file": fname, "entries": entries}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/docs")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    pkg = importlib.import_module(PACKAGE)
    mod_names = [PACKAGE]
    for _imp, name, _ispkg in pkgutil.walk_packages(
            pkg.__path__, prefix=PACKAGE + "."):
        mod_names.append(name)

    results = []
    failures = []
    for mn in sorted(mod_names):
        try:
            results.append(_document_module(mn, args.out))
        except Exception as e:  # noqa: BLE001 — report, then fail the build
            failures.append((mn, repr(e)))

    toc = []
    n_entries = 0
    for r in results:
        links = " ".join(
            f'<a href="{r["file"]}#{n}"><code>{n}</code></a>'
            for _m, n, _k in r["entries"])
        n_entries += len(r["entries"])
        toc.append(f'<tr><td><a href="{r["file"]}"><code>{r["module"]}'
                   f'</code></a></td><td>{links}</td></tr>')
    index = (f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>{PACKAGE} API</title><style>{_CSS}</style></head><body>"
             f"<h1>{PACKAGE} — API documentation</h1>"
             f"<p>Differentiable raymarcher + SVGF denoiser in JAX "
             f"(Doxygen-parity docs; see README.md).</p>"
             f"<table><tr><th>module</th><th>symbols</th></tr>"
             + "\n".join(toc) + "</table></body></html>")
    with open(os.path.join(args.out, "index.html"), "w") as f:
        f.write(index)

    print(f"documented {len(results)} modules, {n_entries} symbols "
          f"-> {args.out}/index.html")
    if failures:
        for mn, err in failures:
            print(f"FAILED to document {mn}: {err}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
