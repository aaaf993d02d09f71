"""engines.yaml loader: the templated engine-config DSL.

Re-implements the semantics of the reference's config system
(gyre/engines_yaml.py:40-435): `!include <glob>` file composition,
conditional `!include(flag)`, template inheritance via `template:` chains,
`{{var}}` / `{{var:default}}` substitution, `{{#flag}}...{{/flag}}` and
`{{^flag}}` sections, and deep-merging of entries by id/model_id.

Design difference: rather than custom YAML constructors mutating a node
tree, we parse plain YAML and run a pure post-pass (include resolution ->
template expansion -> variable substitution -> merge). Same config files,
simpler machine.
"""

from __future__ import annotations

import glob as globmod
import os
import re
from typing import Any

import yaml


class _IncludeTag:
    def __init__(self, pattern: str, flag: str | None = None):
        self.pattern = pattern
        self.flag = flag


def _include_constructor(loader, node):
    tag = node.tag  # !include or !include(flag)
    m = re.match(r"!include(?:\((\w+)\))?$", tag)
    flag = m.group(1) if m else None
    return _IncludeTag(loader.construct_scalar(node), flag)


def _none_constructor(loader, node):
    return None


class TagTemplate:
    """A `!<extends>/<name>` (concrete) or `!@<extends>/<name>` (abstract)
    tagged document — the reference's tag-based template DSL
    (gyre/engines_yaml.py:26-79). `params` is the variable mapping; the
    body `mappings` are config entries rendered by walk_template."""

    def __init__(self, id: str, extends: str, abstract: bool,
                 params: dict, mappings: list):
        self.id = id
        self.extends = extends
        self.abstract = abstract
        self.params = params
        self.mappings = mappings


class TagParams:
    def __init__(self, mapping: dict):
        self.mapping = mapping


_TEMPLATE_TAG_RE = re.compile(r"^!(@?)([\w.-]+)/([\w.-]+)$")


def _template_constructor(loader, tag_suffix, node):
    tag = node.tag
    m = _TEMPLATE_TAG_RE.match(tag)
    if not m:
        raise yaml.constructor.ConstructorError(
            None, None, f"unknown tag {tag!r}", node.start_mark)
    abstract, extends, name = bool(m.group(1)), m.group(2), m.group(3)
    if isinstance(node, yaml.MappingNode):
        params = loader.construct_mapping(node, deep=True)
        mappings = []
    else:
        items = loader.construct_sequence(node, deep=True)
        params = next((i.mapping for i in items
                       if isinstance(i, TagParams)), {})
        mappings = [i for i in items if not isinstance(i, TagParams)]
    return TagTemplate(name, extends, abstract, params, mappings)


def _params_constructor(loader, node):
    return TagParams(loader.construct_mapping(node, deep=True))


class _Loader(yaml.SafeLoader):
    pass


_Loader.add_constructor("!none", _none_constructor)
_Loader.add_constructor("!params", _params_constructor)
for t in ["!include"]:
    _Loader.add_constructor(t, _include_constructor)
_Loader.add_multi_constructor(
    "!include(", lambda loader, suffix, node: _IncludeTag(
        loader.construct_scalar(node), suffix.rstrip(")")))
# catch-all: template tags (!sd1x/my-engine). Registered last so the
# !include( prefix wins for include tags.
_Loader.add_multi_constructor("!", _template_constructor)


def _load_file(path: str, flags: dict[str, bool], seen: set[str]) -> list:
    """Load one yaml file (possibly multi-document), resolving !include
    tags depth-first."""
    rp = os.path.realpath(path)
    if rp in seen:
        raise ValueError(f"recursive include of {path}")
    seen = seen | {rp}
    with open(path) as fh:
        docs = [d for d in yaml.load_all(fh, Loader=_Loader) if d is not None]
    doc = []
    for d in docs:
        if isinstance(d, list):
            doc.extend(d)
        else:
            doc.append(d)
    if len(docs) == 1 and not isinstance(docs[0], list):
        doc = docs[0]
    return _resolve_includes(doc, os.path.dirname(path), flags, seen)


def _resolve_includes(node, base: str, flags, seen):
    if isinstance(node, _IncludeTag):
        if node.flag is not None and not flags.get(node.flag):
            return []
        out = []
        paths = sorted(globmod.glob(os.path.join(base, node.pattern)))
        for p in paths:
            sub = _load_file(p, flags, seen)
            if isinstance(sub, list):
                out.extend(sub)
            elif sub is not None:
                out.append(sub)
        return out
    if isinstance(node, list):
        out = []
        for item in node:
            r = _resolve_includes(item, base, flags, seen)
            if isinstance(item, _IncludeTag):
                out.extend(r if isinstance(r, list) else [r])
            else:
                out.append(r)
        return out
    if isinstance(node, dict):
        return {k: _resolve_includes(v, base, flags, seen)
                for k, v in node.items()}
    return node


# ------------------------------------------------------------- templating

_VAR_RE = re.compile(r"\{\{([#^/>]?)([\w.]+)(?::([^}]*))?\}\}")


def _render_str(s: str, vars: dict) -> Any:
    """Substitute {{var}} / {{var:default}} in a string; if the whole string
    is one variable reference, return the raw value (keeps types)."""
    m = _VAR_RE.fullmatch(s.strip())
    if m and not m.group(1):
        name, default = m.group(2), m.group(3)
        return vars.get(name, default if default is not None else "")

    def sub(mm):
        if mm.group(1):
            return mm.group(0)  # section tags handled structurally
        v = vars.get(mm.group(2), mm.group(3))
        return "" if v is None else str(v)

    return _VAR_RE.sub(sub, s)


def _render(node, vars: dict):
    """Recursive variable substitution + section handling.

    Dict keys of the form '{{#flag}}' / '{{^flag}}' gate their subtree on a
    truthy/falsy variable and splice the subtree's keys into the parent.
    """
    if isinstance(node, str):
        return _render_str(node, vars)
    if isinstance(node, list):
        return [_render(x, vars) for x in node]
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            m = _VAR_RE.fullmatch(str(k)) if isinstance(k, str) else None
            if m and m.group(1) in ("#", "^"):
                flag = bool(vars.get(m.group(2)))
                want = flag if m.group(1) == "#" else not flag
                if want and isinstance(v, dict):
                    out.update(_render(v, vars))
                continue
            out[_render_str(k, vars) if isinstance(k, str) else k] = \
                _render(v, vars)
        return out
    return node


def deep_merge(base, overlay):
    """Overlay wins; dicts merge recursively; an overlay value of None
    deletes the key (reference merge_dict, gyre/engines_yaml.py:257-269);
    lists replace."""
    if isinstance(base, dict) and isinstance(overlay, dict):
        out = dict(base)
        for k, v in overlay.items():
            if v is None and k in out:
                del out[k]
            elif k in base:
                out[k] = deep_merge(base.get(k), v)
            else:
                out[k] = v
        return out
    return overlay


# ------------------------------------------- tag-based templates (!x/y)

class _Bubble:
    """A list escaping from a single-key section dict up into the parent
    list (reference Bubble, gyre/engines_yaml.py:158-160)."""

    def __init__(self, val):
        self.val = val


_PARTIAL_RE = re.compile(r"\{\{>\s*(.*?)\s*\}\}")
_BOOL_RE = re.compile(r"\{\{([#^])\s*(.*?)\s*\}\}")
_FULLVAR_RE = re.compile(r"\{\{(.*?)\}\}$")
_ANYVAR_RE = re.compile(r"\{\{(.*?)\}\}")


def _ctx_get(context: dict, key: str):
    """Context lookup with a YAML-parsed default after ':'
    ({{enabled:False}}, {{vae:'@vae-id'}})."""
    default = None
    if ":" in key:
        key, raw = key.split(":", 1)
        default = yaml.safe_load(raw)
    return context.get(key, default)


def walk_template(el, context: dict):
    """Render a tag-template body against a param context: {{var}} /
    {{var:default}} substitution, {{> partial}} splices, {{#flag}} /
    {{^flag}} boolean sections with dict-update and list-bubble semantics
    (reference walk_template, gyre/engines_yaml.py:163-255)."""
    if isinstance(el, dict):
        res = {}
        is_single = len(el) == 1
        for k, v in el.items():
            if isinstance(k, str) and (m := _PARTIAL_RE.match(k)):
                ko = walk_template(k, context)
                if isinstance(ko, dict):
                    res.update(ko)
                elif is_single and isinstance(ko, list):
                    return _Bubble(ko)
                elif ko:
                    raise ValueError(
                        f"partial {m.group(1)} returned {type(ko).__name__},"
                        " not a dict")
            elif isinstance(k, str) and (m := _BOOL_RE.match(k)):
                if walk_template(k, context):
                    vo = walk_template(v, context)
                    if isinstance(vo, dict):
                        res.update(vo)
                    elif is_single and isinstance(vo, list):
                        return _Bubble(vo)
                    elif vo:
                        raise ValueError(
                            f"section {m.group(2)} value is "
                            f"{type(vo).__name__}, not a dict")
            else:
                ko = walk_template(k, context)
                vo = walk_template(v, context)
                if isinstance(vo, _Bubble):
                    raise ValueError(f"bubbled list under key {k!r}")
                res[ko] = vo
        return res
    if isinstance(el, list):
        res = []
        for v in el:
            vo = walk_template(v, context)
            if isinstance(vo, _Bubble):
                res.extend(vo.val)
            elif vo:
                res.append(vo)
        return res
    if isinstance(el, str):
        if m := _PARTIAL_RE.match(el):
            return _ctx_get(context, m.group(1))
        if m := _BOOL_RE.match(el):
            val = _ctx_get(context, m.group(2))
            return not val if m.group(1) == "^" else val
        if m := _FULLVAR_RE.match(el):
            return _ctx_get(context, m.group(1))
        return _ANYVAR_RE.sub(
            lambda m: str(_ctx_get(context, m.group(1)) or ""), el)
    return el


def flatten_tag_templates(entries: list) -> list:
    """Same-id TagTemplates merge params and body entries (reference
    flatten_templates, gyre/engines_yaml.py:289-308): lets user overlays
    extend a shipped template."""
    res, templates = [], {}
    for item in entries:
        if isinstance(item, TagTemplate) and item.id in templates:
            prev = templates[item.id]
            prev.params = deep_merge(prev.params, item.params)
            prev.mappings = merge_by_id(prev.mappings + item.mappings)
        else:
            res.append(item)
            if isinstance(item, TagTemplate):
                templates[item.id] = item
    return res


def apply_tag_templates(entries: list) -> list:
    """Expand concrete `!ext/name` instances through their abstract
    `!@...` chains (reference apply_templates, gyre/engines_yaml.py:
    311-345): the context starts at {id}, each level renders its body
    then folds its params into the context, until `extends` reaches the
    root 'template'."""
    res, templates = [], {}
    for item in entries:
        if not isinstance(item, TagTemplate):
            res.append(item)
            continue
        if item.abstract:
            templates[item.id] = item
            continue
        context = {"id": item.id}
        mappings: list = []
        template: TagTemplate | None = item
        depth = 0
        while template is not None:
            depth += 1
            if depth > 16:
                raise ValueError(f"template chain too deep at {item.id}")
            output = walk_template(template.mappings, context)
            mappings = merge_by_id(output + mappings)
            context = deep_merge(
                context, walk_template(template.params, context))
            if template.extends and template.extends != "template":
                if template.extends not in templates:
                    raise KeyError(
                        f"unknown template {template.extends!r} "
                        f"(instantiating {item.id})")
                template = templates[template.extends]
            else:
                template = None
        res.extend(mappings)
    return res


def apply_templates(entries: list[dict]) -> list[dict]:
    """Expand `template: <id>` inheritance chains. Entries with
    `abstract: true` are templates only and removed from output.
    Variables in the child's `params:` dict render the parent's body."""
    by_id = {}
    for e in entries:
        if isinstance(e, dict) and "id" in e:
            by_id[e["id"]] = e

    def expand(e, depth=0):
        if depth > 16:
            raise ValueError("template chain too deep")
        tpl_id = e.get("template")
        if not tpl_id:
            return e
        parent = by_id.get(tpl_id)
        if parent is None:
            raise KeyError(f"unknown template {tpl_id!r}")
        parent = expand(parent, depth + 1)
        vars = dict(parent.get("params") or {})
        vars.update(e.get("params") or {})
        vars.setdefault("id", e.get("id"))
        body = _render({k: v for k, v in parent.items()
                        if k not in ("id", "abstract", "template", "params")},
                       vars)
        child = {k: v for k, v in e.items() if k not in ("template", "params")}
        merged = deep_merge(body, child)
        return merged

    out = []
    for e in entries:
        if not isinstance(e, dict):
            continue
        if e.get("abstract"):
            continue
        out.append(expand(e))
    return out


def merge_by_id(entries: list[dict]) -> list[dict]:
    """Later entries with the same id/model_id/hintset_id deep-merge into
    earlier ones (user overlay semantics, reference
    gyre/engines_yaml.py:258-288)."""
    keys = ("id", "model_id", "hintset_id")
    out: list[dict] = []
    index: dict[tuple, int] = {}
    for e in entries:
        k = next(((kk, e[kk]) for kk in keys if kk in e), None)
        if k is not None and k in index:
            out[index[k]] = deep_merge(out[index[k]], e)
        else:
            if k is not None:
                index[k] = len(out)
            out.append(e)
    return out


def check_and_update(dist_dir: str, user_dir: str,
                     attic_name: str = "_attic") -> list[str]:
    """Sync distributed config files into a user config dir: unedited user
    copies (content matches any previously-shipped hash) are updated in
    place; edited ones are left alone with the new dist file written
    alongside as `<name>.new`; obsolete unedited files retire to _attic
    (reference git-blob-hash auto-update, gyre/engines_yaml.py:381-435).

    Returns the list of updated/created file names."""
    import hashlib
    import shutil

    os.makedirs(user_dir, exist_ok=True)
    hashes_path = os.path.join(user_dir, ".dist_hashes")
    old_hashes: dict[str, str] = {}
    if os.path.exists(hashes_path):
        with open(hashes_path) as fh:
            for line in fh:
                h, _, name = line.strip().partition(" ")
                if name:
                    old_hashes[name] = h

    def digest(path):
        with open(path, "rb") as fh:
            return hashlib.sha1(fh.read()).hexdigest()

    def walk(d):
        for root, _dirs, files in os.walk(d):
            for f in sorted(files):
                yield os.path.relpath(os.path.join(root, f), d)

    changed = []
    new_hashes = {}
    for name in sorted(walk(dist_dir)):
        src = os.path.join(dist_dir, name)
        new_hashes[name] = digest(src)
        dst = os.path.join(user_dir, name)
        if not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            shutil.copy2(src, dst)
            changed.append(name)
        elif digest(dst) == old_hashes.get(name):
            if digest(dst) != new_hashes[name]:
                shutil.copy2(src, dst)
                changed.append(name)
        elif digest(dst) != new_hashes[name]:
            shutil.copy2(src, dst + ".new")  # user-edited: don't clobber
    # retire unedited files no longer shipped
    for name, h in old_hashes.items():
        if name in new_hashes:
            continue
        dst = os.path.join(user_dir, name)
        if os.path.exists(dst) and digest(dst) == h:
            attic_dst = os.path.join(user_dir, attic_name, name)
            os.makedirs(os.path.dirname(attic_dst), exist_ok=True)
            shutil.move(dst, attic_dst)
    with open(hashes_path, "w") as fh:
        for name, h in new_hashes.items():
            fh.write(f"{h} {name}\n")
    return changed


def load(path: str, flags: dict[str, bool] | None = None,
         vars: dict | None = None) -> list[dict]:
    """Load an engines.yaml (with includes/templates/overlays resolved)."""
    flags = flags or {}
    doc = _load_file(path, flags, set())
    if isinstance(doc, dict):
        doc = [doc]
    entries = []
    for item in doc or []:
        if isinstance(item, list):
            entries.extend(item)
        elif item is not None:
            entries.append(item)
    if vars:
        entries = [_render(e, vars) if not isinstance(e, TagTemplate) else e
                   for e in entries]
    entries = flatten_tag_templates(entries)
    entries = apply_tag_templates(entries)
    entries = merge_by_id(entries)
    entries = apply_templates(entries)
    return entries
