"""The GPU operator guide (``docs/guide/gpu/*.md``) held against the
port's code.

A chapter may name only what the port has: each ``gpumounterctl``
subcommand, master or worker route, ``TPU_*`` variable, ``tpumounter_*``
metric family and event it names must exist in ``gpumounter_tpu_torch/``;
its links and ``path:line`` cites must resolve; a term that means
something only on a TPU may stand only in a sentence that names the
control plane's chapter or calls the name kept; a paragraph that takes a
number from ``PERF.md`` names the card and its power limit; each span of
the training step it names (a backticked ``train.*``, ``model.*`` or
``attn.*`` name of lowercase words) is one the port opens. Every section
of the control plane's chapter is linked from its GPU chapter (a GPU
section, or one line on why it has no GPU meaning), and the FAQ answers
each of the control plane's questions.

The lint imports no jax and needs no card: ``python -m pytest
tests/test_torch_guide.py -q``. Planted faults show that each rule
rejects what it is for.
"""

from __future__ import annotations

import argparse
import ast
import functools
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gpumounter_tpu_torch")
GUIDE = os.path.join(REPO, "docs", "guide")
GPU_GUIDE = os.path.join(GUIDE, "gpu")
CHAPTERS = ("QuickStart", "Robustness", "Elasticity", "HA", "Migration",
            "Multitenancy", "Observability", "Performance", "FAQ")

# Terms that mean something only on a TPU (or only in the control plane's
# names where the port renamed them). Each may stand only in a sentence
# that links the control plane's chapter (``](../``) or says the name is
# kept.
TPU_ONLY = [r"google\.com/tpu", r"/dev/accel", r"/dev/vfio", r"tpumounterctl",
            r"jax\.devices", r"jax\.distributed", r"\bjaxcheck\b",
            r"\blibtpu\b", r"\b[Pp]allas\b", r"\bTPUBusy\b",
            r"\bTPUAttach\w*", r"\bTPUDetach\w*", r"\bInsufficientTPU\b",
            r"\bTPU_NOT_FOUND\b", r"\bTPU_VISIBLE_CHIPS\b", r"\bv5p\b",
            r"\bv5e\b", r"\bv4-\d", r"\btpusPerHost\b", r"/addtpu",
            r"/removetpu", r"/tpustatus", r"\btpu-mounter-worker\b",
            r"\btpu-pool\b", r"gke-tpu", r"\bICI\b", r"\bMXU\b",
            r"\btpu_selftest\b", r"\btpuprobe\b"]
KEPT = re.compile(r"\]\(\.\./|\bkept\b|\bkeeps\b")

# First path segments a route may start with besides the port's own: the
# control plane's routes (a TPU-only term, held by that rule instead).
TPU_ROUTE_HEADS = {"addtpu", "removetpu", "tpustatus", "addtpuslice",
                   "removetpuslice"}
CITE_EXTS = "py|md|cc|cu|cuh|h|proto|yaml|yml|json|sh|toml|txt|jsonl"
CITE = re.compile(r"(?<![\w/.-])([\w][\w./-]*\.(?:" + CITE_EXTS
                  + r")):(\d+)(?:-(\d+))?\b")
REPO_PATH = re.compile(r"^[\w.-]+(?:/[\w.-]+)+\.(?:" + CITE_EXTS + r")$")
EVENT_FAMILIES = {"admit", "queue", "preempt", "lease", "waiter", "idle",
                  "slice", "gang", "election", "defrag", "node", "drain",
                  "spot", "circuit", "fast", "flight", "journal", "pool",
                  "agent", "gate", "device", "request"}
K8S_REASON = re.compile(r"\bGPU(?:Attach|Detach|Busy)[A-Za-z]*\b")
PERF_NUMBER = re.compile(r"\d+\.\d+|\b\d+ ?(?:ms|s|GB|MB|%)\b")
POWER = re.compile(r"\b\d+(?:\.\d+)? W\b")


# -- the port's facts ------------------------------------------------------------

def _port_sources() -> list[str]:
    out = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "build")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@functools.lru_cache(maxsize=None)
def _trees() -> dict[str, ast.AST]:
    trees = {}
    for path in _port_sources():
        with open(path) as f:
            trees[path] = ast.parse(f.read())
    return trees


def _docstring_nodes(tree: ast.AST) -> set[int]:
    ids = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            ids.add(id(body[0].value))
    return ids


@functools.lru_cache(maxsize=None)
def port_strings() -> frozenset:
    """Every string constant of the port's code, docstrings left out."""
    out = set()
    for tree in _trees().values():
        skip = _docstring_nodes(tree)
        out |= {n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and id(n) not in skip}
    return frozenset(out)


@functools.lru_cache(maxsize=None)
def port_env() -> frozenset:
    return frozenset(name for s in port_strings()
                     for name in re.findall(r"\bTPU_[A-Z0-9_]*[A-Z0-9]", s))


@functools.lru_cache(maxsize=None)
def port_families() -> frozenset:
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    return frozenset(re.findall(r"^# TYPE (\S+)", REGISTRY.render_text(),
                                re.M))


@functools.lru_cache(maxsize=None)
def port_step_spans() -> frozenset:
    """The profiler ranges the port's training step opens: the name of
    every ``with region(name)`` block, and ``<name>.bwd`` where the block
    carries its region into the backward (``r.carry(...)`` on its handle
    ``r``)."""
    out = set()
    for tree in _trees().values():
        for node in ast.walk(tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if not (isinstance(call, ast.Call) and call.args
                        and getattr(call.func, "id", getattr(
                            call.func, "attr", None)) == "region"
                        and isinstance(call.args[0], ast.Constant)):
                    continue
                name = call.args[0].value
                out.add(name)
                var = item.optional_vars
                if isinstance(var, ast.Name) and any(
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "carry"
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id == var.id
                        for stmt in node.body for n in ast.walk(stmt)):
                    out.add(name + ".bwd")
    return frozenset(out)


def _values(node: ast.AST, module_strings: set[str]) -> set[str]:
    """What a kind argument can be: a constant, either branch of a
    conditional, or an f-string's constant prefix joined to any string
    constant of its module."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.IfExp):
        return _values(node.body, module_strings) | _values(
            node.orelse, module_strings)
    if isinstance(node, ast.JoinedStr) and node.values \
            and isinstance(node.values[0], ast.Constant):
        prefix = node.values[0].value
        return {prefix + s for s in module_strings
                if re.fullmatch(r"[a-z_]+", s)}
    return set()


@functools.lru_cache(maxsize=None)
def port_events() -> tuple[frozenset, frozenset]:
    """(lifecycle event kinds, Kubernetes Event reasons) the port emits:
    the first argument of every ``*.emit(...)`` call and the reason of
    every ``_record_event(pod, reason, ...)`` call."""
    kinds, reasons = set(), set()
    for tree in _trees().values():
        strings = {n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant)
                   and isinstance(n.value, str)}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr == "emit" and node.args:
                kinds |= _values(node.args[0], strings)
            elif node.func.attr == "_record_event" and len(node.args) > 1:
                reasons |= _values(node.args[1], strings)
    return frozenset(kinds), frozenset(reasons)


@functools.lru_cache(maxsize=None)
def port_cli() -> tuple[dict, set]:
    """The port's ``gpumounterctl`` parser: {subcommand: positional
    choices} and the global options that take a value."""
    from gpumounter_tpu_torch.cli import build_parser
    parser = build_parser()
    subs: dict[str, set] = {}
    valued = set()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                subs[name] = set().union(*[
                    set(a.choices) for a in sub._actions
                    if a.choices and not a.option_strings] or [set()])
        elif action.option_strings and action.nargs != 0:
            valued.update(action.option_strings)
    return subs, valued


@functools.lru_cache(maxsize=None)
def port_routes() -> tuple[frozenset, tuple]:
    """(plain paths, parametrised route patterns) the port's master and
    worker serve: the gateway's ``_PLAIN_ROUTES``, ``/metrics`` and the
    patterns ``_route`` matches; the worker sidecar's paths
    (``worker/main.py``)."""
    from gpumounter_tpu_torch.master import gateway
    plain = set(gateway._PLAIN_ROUTES) | {"/metrics"}
    patterns = tuple(v for k, v in vars(gateway).items()
                     if k.endswith("_RE") and isinstance(v, re.Pattern)
                     and v.pattern.startswith("^/"))
    with open(os.path.join(PORT, "worker", "main.py")) as f:
        tree = ast.parse(f.read())
    plain |= {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)
              and re.fullmatch(r"/[a-z]+", n.value)}
    return frozenset(plain), patterns


def _route_heads() -> set[str]:
    plain, patterns = port_routes()
    heads = {p.strip("/").split("/")[0] for p in plain}
    heads |= {re.match(r"\^/(\w+)", p.pattern).group(1) for p in patterns}
    return heads | TPU_ROUTE_HEADS


# -- reading a chapter -----------------------------------------------------------

def _split(text: str) -> tuple[list[str], list[str], list[str]]:
    """(prose lines, code-block lines, code blocks) of a chapter."""
    prose, code_lines, blocks = [], [], []
    block: list[str] | None = None
    for line in text.splitlines():
        if line.lstrip().startswith("```"):
            if block is None:
                block = []
            else:
                blocks.append("\n".join(block))
                block = None
            continue
        if block is None:
            prose.append(line)
        else:
            block.append(line)
            code_lines.append(line)
    return prose, code_lines, blocks


def _spans(prose: list[str]) -> list[str]:
    return re.findall(r"`([^`\n]+)`", "\n".join(prose))


def _paragraphs(prose: list[str]) -> list[str]:
    """Blank-line separated blocks, each list item and each table on its
    own."""
    out, cur = [], []

    def flush():
        if cur:
            out.append("\n".join(cur))
            cur.clear()
    for line in prose:
        if not line.strip():
            flush()
        elif re.match(r"\s{0,3}(?:[-*]|\d+\.) ", line) or line.startswith(
                "#"):
            flush()
            cur.append(line)
        elif line.startswith("|") != bool(cur and cur[0].startswith("|")):
            flush()
            cur.append(line)
        else:
            cur.append(line)
    flush()
    return out


def _units(text: str) -> list[str]:
    """Sentences of prose, table rows and headings, and whole code blocks:
    what a kept-name statement must share with a TPU-only term."""
    prose, _, blocks = _split(text)
    units = list(blocks)
    for para in _paragraphs(prose):
        if para.startswith("|"):
            units += para.splitlines()
            continue
        flat = " ".join(line.strip() for line in para.splitlines())
        units += re.split(r"(?<=[.!?])\s+(?=[A-Z`(\[*\"])", flat)
    return units


def _slug(heading: str) -> str:
    text = heading.strip().lstrip("#").strip().lower()
    return re.sub(r"[^\w\- ]", "", text).replace(" ", "-")


def _anchors(path: str) -> set[str]:
    with open(path) as f:
        prose, _, _ = _split(f.read())
    return {_slug(line) for line in prose if re.match(r"#{1,6} ", line)}


def _resolve(rel: str, base: str) -> str | None:
    for root in (base, REPO, PORT, os.path.join(REPO, "gpumounter_tpu"),
                 os.path.join(PORT, "torchcheck")):
        path = os.path.normpath(os.path.join(root, rel))
        if os.path.isfile(path):
            return path
    return None


# -- the rules -------------------------------------------------------------------

def check_subcommands(text: str, base: str) -> list[str]:
    subs, valued = port_cli()
    prose, code_lines, _ = _split(text)
    faults = []
    for snippet in _spans(prose) + code_lines:
        for m in re.finditer(r"\bgpumounterctl\b((?:\s+[^\s|;&#]+)*)",
                             snippet):
            words = m.group(1).split()
            i = 0
            while i < len(words) and words[i].startswith("-"):
                i += 2 if words[i] in valued else 1
            if i >= len(words) or re.search(r"[<>$.\[\]{}()`\"']",
                                            words[i]):
                continue
            sub = words[i]
            if sub not in subs:
                faults.append(f"gpumounterctl {sub}: no such subcommand")
                continue
            rest = [w for w in words[i + 1:] if not w.startswith("-")]
            if subs[sub] and rest and re.fullmatch(r"[a-z]+", rest[0]) \
                    and rest[0] not in subs[sub]:
                faults.append(f"gpumounterctl {sub} {rest[0]}: not one of "
                              f"{sorted(subs[sub])}")
    return faults


def _route_candidates(text: str) -> set[str]:
    prose, code_lines, _ = _split(text)
    found = set()
    host = (r"(?:https?://[^/\s\"'`]+|\$\{?[A-Z_]+\}?|localhost:\d+"
            r"|127\.0\.0\.1(?::[\d$(){}A-Z_+]+)?)")
    for snippet in _spans(prose) + code_lines:
        for m in re.finditer(host + r"(/[^\s\"'`\\)]*)", snippet):
            found.add(m.group(1))
    for span in _spans(prose):
        m = re.fullmatch(r"(?:(?:GET|POST) )?(/[^\s]*)", span.strip())
        if m:
            found.add(m.group(1))
    return found


def check_routes(text: str, base: str) -> list[str]:
    plain, patterns = port_routes()
    heads = _route_heads()
    faults = []
    for raw in sorted(_route_candidates(text)):
        path = re.split(r"[?#]", raw)[0]
        prefix = path.endswith("/...")
        path = path[:-4] if prefix else path.rstrip(".,:;")
        segs = path.strip("/").split("/")
        if not segs[0] or (segs[0] not in heads and not re.fullmatch(
                r"[a-z]+z", segs[0])):
            continue
        if "tpu" in path:
            continue            # a control-plane route: TPU-only term
        # a route named by its first segment alone (`/addgpu`)
        prefix = prefix or len(segs) == 1
        sample = "/".join(
            "1" if re.fullmatch(r":\w+|<[^>]*>|\$\{?\w+\}?|\{\w+\}", s)
            else s for s in path.split("/"))
        ok = sample in plain or any(p.match(sample) for p in patterns)
        if prefix and not ok:
            # a route of each pattern, every parameter "1"
            examples = set(plain) | {
                re.sub(r"\(\?P<\w+>[^)]*\)", "1", p.pattern).strip("^$")
                for p in patterns}
            ok = any(e.startswith(sample + "/") for e in examples)
        if not ok:
            faults.append(f"{raw}: no route of the port's master or worker")
    return faults


def check_env(text: str, base: str) -> list[str]:
    env = port_env()
    faults = []
    for m in re.finditer(r"\bTPU_[A-Z0-9_]*(?:\{[A-Z0-9_,]+\}[A-Z0-9_]*)?"
                         r"\*?", text):
        token = m.group(0)
        brace = re.search(r"\{([A-Z0-9_,]+)\}", token)
        names = ([token[:brace.start()] + part + token[brace.end():]
                  for part in brace.group(1).split(",")] if brace
                 else [token])
        for name in names:
            if name.endswith(("*", "_")):
                ok = any(e.startswith(name.rstrip("*")) for e in env)
            else:
                ok = name in env
            if not ok:
                faults.append(f"{name}: the port reads no such variable")
    return faults


def check_metrics(text: str, base: str) -> list[str]:
    families = port_families()
    faults = []
    for token in sorted(set(re.findall(r"\btpumounter_[a-z0-9_]+", text))):
        name = re.sub(r"_(?:bucket|count|sum)$", "", token)
        if name not in families:
            faults.append(f"{token}: not a family of the port's REGISTRY")
    return faults


def check_events(text: str, base: str) -> list[str]:
    kinds, reasons = port_events()
    faults = [f"{r}: not a Kubernetes Event reason the port emits"
              for r in sorted(set(K8S_REASON.findall(text)) - reasons)]
    for unit in _units(text):
        if not re.search(r"\bevents?\b", re.sub(r"`[^`]*`", "", unit),
                         re.I):
            continue
        for token in re.findall(r"`([a-z]+(?:_[a-z]+)+)`", unit):
            if token.split("_")[0] not in EVENT_FAMILIES \
                    or re.search(r"_(?:s|ms|total|seconds|ticks|max|"
                                 r"min|id|path|dir)$", token):
                continue
            if token not in kinds:
                faults.append(f"{token}: not an event kind the port "
                              "emits")
    return sorted(set(faults))


def check_links(text: str, base: str) -> list[str]:
    faults = []
    prose, _, _ = _split(text)
    here = {_slug(line) for line in prose if re.match(r"#{1,6} ", line)}
    for target in re.findall(r"\]\(([^)\s]+)\)", "\n".join(prose)):
        if re.match(r"[a-z]+:", target):
            continue
        path, _, anchor = target.partition("#")
        if not path:
            if anchor not in here:
                faults.append(f"#{anchor}: no such heading here")
            continue
        full = os.path.normpath(os.path.join(base, path))
        if not os.path.exists(full):
            faults.append(f"{target}: no such file")
        elif anchor and full.endswith(".md") and anchor not in _anchors(
                full):
            faults.append(f"{target}: no such heading in {path}")
    for m in CITE.finditer(text):
        rel, first = m.group(1), int(m.group(2))
        last = int(m.group(3) or first)
        path = _resolve(rel, base)
        if path is None:
            faults.append(f"{m.group(0)}: no such file in the repo")
            continue
        with open(path, errors="replace") as f:
            n = sum(1 for _ in f)
        if not 1 <= first <= last <= n:
            faults.append(f"{m.group(0)}: {rel} has {n} lines")
    for span in _spans(prose):
        if REPO_PATH.match(span.strip()) and "*" not in span \
                and _resolve(span.strip(), base) is None:
            faults.append(f"{span}: no such file in the repo")
    return faults


def check_tpu_terms(text: str, base: str) -> list[str]:
    faults = []
    for unit in _units(text):
        if KEPT.search(unit):
            continue
        for term in TPU_ONLY:
            m = re.search(term, unit)
            if m:
                faults.append(f"{m.group(0)!r} outside a sentence that "
                              f"names the control plane's chapter or "
                              f"calls it kept: {unit[:120]!r}")
    return faults


def check_perf_numbers(text: str, base: str) -> list[str]:
    """A list item belongs to the paragraph that leads into it (one that
    ends with a colon): the card may be named there once for the list."""
    prose, _, _ = _split(text)
    faults = []
    lead = ""
    for para in _paragraphs(prose):
        item = re.match(r"\s{0,3}(?:[-*]|\d+\.) ", para)
        if not item:
            lead = para if para.rstrip().endswith(":") else ""
        context = (lead + "\n" + para) if item else para
        if "PERF.md" in para and PERF_NUMBER.search(
                para.replace("PERF.md", "")):
            if "H100" not in context or not POWER.search(context):
                faults.append("a number from PERF.md without the card and "
                              f"its power limit: {para[:160]!r}")
    return faults


def check_step_spans(text: str, base: str) -> list[str]:
    """A backticked name of lowercase words under one of the heads of the
    port's step spans (``train``, ``model``, ``attn``) is a span name,
    unless its last word is a file's extension (``model.py``)."""
    spans = port_step_spans()
    heads = "|".join(sorted({s.split(".")[0] for s in spans}))
    pattern = re.compile(rf"(?:{heads})(?:\.[a-z]+)+")
    prose, _, _ = _split(text)
    faults = []
    for token in sorted(set(_spans(prose))):
        token = token.strip()
        if pattern.fullmatch(token) and token not in spans \
                and token.rsplit(".", 1)[1] not in CITE_EXTS.split("|"):
            faults.append(f"{token}: not a span the port's step opens")
    return faults


RULES = {"subcommands": check_subcommands, "routes": check_routes,
         "env": check_env, "metrics": check_metrics, "events": check_events,
         "links": check_links, "tpu_terms": check_tpu_terms,
         "perf_numbers": check_perf_numbers, "step_spans": check_step_spans}


def _chapter(name: str) -> str:
    with open(os.path.join(GPU_GUIDE, name + ".md")) as f:
        return f.read()


# -- the chapters ----------------------------------------------------------------

def test_the_gpu_guide_has_its_nine_chapters():
    present = {f[:-3] for f in os.listdir(GPU_GUIDE) if f.endswith(".md")}
    assert present == set(CHAPTERS)
    for name in CHAPTERS:
        assert os.path.isfile(os.path.join(GUIDE, name + ".md")), name


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("chapter", CHAPTERS)
def test_chapter_names_only_what_the_port_has(chapter, rule):
    faults = RULES[rule](_chapter(chapter), GPU_GUIDE)
    assert not faults, "\n".join(faults)


@pytest.mark.parametrize("chapter", CHAPTERS)
def test_chapter_opens_by_naming_its_control_plane_chapter(chapter):
    prose, _, _ = _split(_chapter(chapter))
    first = next(p for p in _paragraphs(prose) if not p.startswith("#"))
    assert f"](../{chapter}.md)" in first, first


@pytest.mark.parametrize("chapter", [c for c in CHAPTERS if c != "FAQ"])
def test_every_control_plane_section_has_a_gpu_counterpart(chapter):
    """Each ``##``/``###`` section of the control plane's chapter is linked
    (``../<chapter>.md#<section>``) from the GPU chapter: a GPU section,
    or the line that says why it has no GPU meaning."""
    with open(os.path.join(GUIDE, chapter + ".md")) as f:
        prose, _, _ = _split(f.read())
    wanted = [_slug(line) for line in prose if re.match(r"#{2,3} ", line)]
    assert wanted
    linked = set(re.findall(rf"\]\(\.\./{chapter}\.md#([\w-]+)\)",
                            _chapter(chapter)))
    missing = [s for s in wanted if s not in linked]
    assert not missing, f"sections with no GPU counterpart: {missing}"


def _questions(text: str) -> list[str]:
    """The FAQ's questions: lines that are bold from end to end."""
    prose, _, _ = _split(text)
    return [line for line in prose
            if re.fullmatch(r"\*\*[^*].*\*\*\s*", line.strip())]


def test_the_faq_answers_every_control_plane_question():
    """One GPU question per question of the control plane's FAQ, in its
    order, each followed by an answer."""
    with open(os.path.join(GUIDE, "FAQ.md")) as f:
        theirs = _questions(f.read())
    text = _chapter("FAQ")
    ours = _questions(text)
    assert len(theirs) == 22 and len(ours) >= len(theirs), (len(theirs),
                                                            len(ours))
    for question in ours:
        answer = text.split(question, 1)[1].lstrip("\n").split("\n\n")[0]
        assert answer.strip() and not answer.startswith("**"), question


def test_the_lint_imports_no_jax():
    """The lint runs where jax is absent: the port's facts it reads
    (parser, gateway, registry) load without it."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import test_torch_guide as g; "
            "[g.RULES[r](g._chapter(c), g.GPU_GUIDE) for c in g.CHAPTERS "
            "for r in g.RULES]; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules), 'jax imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- planted faults: each rule rejects what it is for ---------------------------

PLANTED = {
    "subcommand": ("subcommands", "Run `gpumounterctl nosuch workload`."),
    "subcommand_choice": ("subcommands",
                          "```bash\ngpumounterctl slice explode\n```"),
    "variable": ("env", "Set `TPU_NO_SUCH_KNOB=1` on the worker."),
    "family": ("metrics", "Alert on `tpumounter_no_such_family_total`."),
    "route": ("routes", "```bash\ncurl \"$BASE/nosuchz\"\n```"),
    "worker_route": ("routes", "The sidecar's `/gatezz` answers it."),
    "k8s_reason": ("events", "The worker posts `GPUDetachStalled` on the Pod."),
    "event_kind": ("events", "The tracker emits a `node_exploded` event."),
    "missing_file": ("links", "See [the plan](NoSuchChapter.md)."),
    "missing_heading": ("links", "See [HA](../HA.md#no-such-section)."),
    "line_past_the_end": ("links",
                          "The default is at `utils/config.py:99999`."),
    "google_tpu": ("tpu_terms",
                   "The slave pod requests `google.com/tpu` here."),
    "tpu_busy": ("tpu_terms", "Detach says 409 TPUBusy."),
    "perf_without_card": ("perf_numbers",
                          "An attach took 32.236 ms (`PERF.md` §5)."),
    "step_span": ("step_spans",
                  "The optimizer's range is `train.optimizer`."),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_a_planted_fault_is_rejected(case):
    rule, text = PLANTED[case]
    assert RULES[rule](text, GPU_GUIDE), f"{case} passed the {rule} rule"


@pytest.mark.parametrize("rule,text", [
    ("subcommands", "```bash\ngpumounterctl --master $BASE slice status\n"
                    "```"),
    ("routes", "curl `$BASE/addgpu/namespace/:ns/pod/:pod/gpu/:n/"
               "isEntireMount/:b` and `/removegpu/...`"),
    ("env", "The client reads `TPU_MOUNTER_TLS_*`."),
    ("tpu_terms", "The control plane's `google.com/tpu` is kept as a "
                  "name only in [its chapter](../QuickStart.md)."),
    ("perf_numbers", "32.236 ms on an NVIDIA H100 80GB HBM3 at 700.00 W "
                     "(`PERF.md` §5)."),
    ("step_spans", "`model.norm` opens in `model.py`, `model.norm.bwd` "
                   "on the backward's thread."),
])
def test_what_the_port_has_passes(rule, text):
    assert not RULES[rule](text, GPU_GUIDE)


def test_the_guide_views_rig_runs_on_a_fake_gpu(tmp_path):
    """The rig that produced the chapters' payloads still runs: on one
    fake GPU, in a fresh interpreter (its registries are the process's),
    every check true and every view written."""
    out = tmp_path / "views"
    proc = subprocess.run(
        [sys.executable, "-m", "gpumounter_tpu_torch.testing.guide_views",
         "--out", str(out), "--root", str(tmp_path / "root"),
         "--fake-gpus", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and set(report["checks"]) == {
        "add", "proof", "parked", "remove", "handed_over"}
    for name in ("worker_utilz.json", "worker_topoz.json", "ctl_status.txt",
                 "ctl_node.txt", "brokerz_queued.json", "ctl_trace.txt"):
        assert (out / name).stat().st_size > 0, name
    utilz = json.loads((out / "worker_utilz.json").read_text())
    assert utilz["chips"][0]["duty_source"] == "open-fd"
