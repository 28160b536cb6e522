"""Chat templates: the port's Jinja interpreter (``models/chat_template.py``)
and ``BpeTokenizer.apply_chat_template`` against ``jinja2`` and
``transformers``, on the CPU.

The oracle is ``transformers``' own environment
(``chat_template_utils._compile_jinja_template``: jinja2's
``ImmutableSandboxedEnvironment`` with ``trim_blocks``, ``lstrip_blocks``,
``loopcontrols``, the ``{% generation %}`` tracker, its ``tojson``,
``raise_exception`` and ``strftime_now``), with the clock frozen to one
date on both sides. What is held:

- the four published templates of ``tests/chat_templates.py``
  (Meta-Llama-3-8B-Instruct, Llama-3.1-8B-Instruct,
  Llama-3.2-11B-Vision-Instruct, llava-1.5-7b-hf) render equal strings, or
  raise the same ``raise_exception`` message, over a matrix of
  conversations (system and none, several turns, string and list-of-parts
  content, an image part, unicode, empty content) with and without the
  generation prompt;
- seeded random templates over the subset (4 x 150) render as jinja2
  renders them or fail on both sides;
- small constructed templates, one for each construct of the subset
  (layout and whitespace control, statements, Jinja's frames and the
  ``for``/``else`` rule, expressions, tests, filters, str and dict
  methods, ``range``, Undefined, the sandbox), render as jinja2 renders
  them or fail with the same error class;
- constructs outside the subset fail at compile time, naming themselves
  and their line, where jinja2 compiles them; a unit whose checkpoint
  carries one fails ``load()``;
- template directories (the config's string and list forms,
  ``chat_template.jinja`` over the config, ``additional_chat_templates/``,
  none named ``default``, a SentencePiece-style LLaVA tokenizer,
  ``special_tokens_map.json`` over a legacy config): the special tokens
  map, ``eos_token_id``, the rendered text and its ids without special
  tokens equal ``AutoTokenizer``'s.

The chat route against the JAX package's unit rides beside each family's
own pods and imports: the Llama-3 BPE directory's, with ``/generate``'s
``add_special_tokens``, in ``tests/test_torch_checkpoint.py``; the mllama
directory's, with an image part and ``raise_exception``'s 500, in
``tests/test_torch_mllama.py``; the LLaVA directory's (the
SentencePiece-style tokenizer, llava-1.5's template) in
``tests/test_torch_vlm.py``.
"""

import json
import sys
from datetime import datetime
from pathlib import Path

import pytest

from transformers.utils import chat_template_utils

from scalable_hw_agnostic_inference_tpu_torch.models import chat_template as ct
from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    BpeTokenizer,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chat_templates as T  # noqa: E402
import chip_smoke  # noqa: E402

FROZEN = datetime(2026, 10, 17, 9, 30)


class _FrozenClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return FROZEN


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    """``strftime_now`` reads one date on both sides."""
    monkeypatch.setattr(ct, "datetime", _FrozenClock)
    monkeypatch.setattr(chat_template_utils, "datetime", _FrozenClock)


def _oracle(source, **context):
    """jinja2 under transformers' environment: the text, or the error."""
    try:
        return "ok", chat_template_utils._compile_jinja_template(
            source).render(**context)
    except Exception as e:  # noqa: BLE001 - compared by class and text
        return "error", (type(e).__name__, str(e))


def _port(source, **context):
    try:
        return "ok", ct.ChatTemplate(source).render(**context)
    except Exception as e:  # noqa: BLE001
        return "error", (type(e).__name__, str(e))


# -- the published templates --------------------------------------------------

SYSTEM = {"role": "system", "content": "  You are terse.  "}
IMAGE_TURN = {"role": "user", "content": [
    {"type": "image"}, {"type": "text", "text": "What is in the image?"}]}
CONVERSATIONS = {
    "system": [SYSTEM, {"role": "user", "content": "Hello!"}],
    "no-system": [{"role": "user", "content": "What is 2+2?"}],
    "turns": [SYSTEM, {"role": "user", "content": "Hi"},
              {"role": "assistant", "content": "Hello. How can I help?"},
              {"role": "user", "content": "Tell me a joke."}],
    "parts": [{"role": "user", "content": [
        {"type": "text", "text": "Describe"},
        {"type": "text", "text": "briefly"}]},
        {"role": "assistant", "content": [{"type": "text", "text": "A cat."}]},
        {"role": "user", "content": [{"type": "text", "text": "More?"}]}],
    "image": [IMAGE_TURN],
    "image-system": [SYSTEM, IMAGE_TURN],
    "unicode": [{"role": "user",
                 "content": "Café déjà vu — 日本語 🚀\n\tnew line "}],
    "empty": [{"role": "system", "content": ""},
              {"role": "user", "content": ""}],
}
SPECIAL = {
    "llama": {"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>"},
    "llava": {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
              "pad_token": "<pad>"},
}


def _context(conv, agp, special):
    return dict(special, messages=conv, tools=None, documents=None,
                add_generation_prompt=agp)


@pytest.mark.parametrize("agp", [True, False], ids=["gen", "no-gen"])
@pytest.mark.parametrize("conv", sorted(CONVERSATIONS))
@pytest.mark.parametrize("name", sorted(T.PUBLISHED))
def test_published_template_renders_as_jinja(name, conv, agp):
    source = T.PUBLISHED[name]
    ctx = _context(CONVERSATIONS[conv], agp,
                   SPECIAL["llava" if "llava" in name else "llama"])
    want, got = _oracle(source, **ctx), _port(source, **ctx)
    assert got == want
    if want[0] == "error":
        # the one raise among them: Llama-3.2-Vision's image + system rule
        assert "Vision" in name and conv == "image-system"
        assert want[1] == ("TemplateError", "Prompting with images is "
                           "incompatible with system messages.")


def test_chip_smoke_carries_the_published_templates():
    assert chip_smoke.LLAMA3_INSTRUCT_TEMPLATE == T.LLAMA3_8B_INSTRUCT
    assert chip_smoke.LLAVA15_TEMPLATE == T.LLAVA15_7B


# -- constructed templates, one construct each --------------------------------

CONSTRUCTS = [
    # layout: trim_blocks, lstrip_blocks, -/+ control, comments, newlines
    ("trim-lstrip", "  {% if true %}\n  a\n  {% endif %}\n  b", {}),
    ("minus-control", "{%- set x = 'v' -%}  \n\n  {{ x }}  {{- ' w' }}  \n"
     "{{ 1 -}}\n\n{{- 2 }}", {}),
    ("plus-control", "  {%+ if true %}x{% endif +%}\ny", {}),
    ("comments", "{# c #}\n  {#- c2 -#}  x {# c3 #}\ny\n  {% if 1 %}\n\tz\n"
     "  {%+ endif %}\nw\n", {}),
    ("newlines", "a\r\nb\rc\n", {}),
    ("trailing-newline", "{{ x }}\n", {"x": 1}),
    ("blank-lines", "{% if true %}\n  x\n{% endif %}\n\n  {{ 'v' }}  \n  "
     "{% if 1 %}  y  {% endif %}  \n", {}),
    # for: tuple targets, loop, else, filter, break, continue, scopes
    ("for-loop-vars", "{% for a, b in {'x': 1, 'y': 2} | items %}"
     "{{ loop.index }}{{ a }}={{ b }}{{ loop.index0 }}{{ loop.revindex }}"
     "{{ loop.revindex0 }}{{ loop.first }}{{ loop.last }}{{ loop.length }};"
     "{% endfor %}", {}),
    ("for-else", "{% for x in [] %}a{% else %}empty{% endfor %}"
     "{% for x in [1] %}{{ x }}{% else %}no{% endfor %}", {}),
    ("for-filter", "{% for x in [1, 2, 3] if x > 1 %}{{ loop.index }}{{ x }}"
     "{% endfor %}", {}),
    ("for-unpack", "{% for (a, b) in [(1, 2)] %}{{ a + b }}{% endfor %}"
     "{% for t in [(1, 2), (3, 4)] %}{{ t[0] }}{% endfor %}{% for k in "
     "{'b': 1, 'a': 2} %}{{ k }}{% endfor %}", {}),
    ("break-continue", "{% for x in range(10) %}{% if x is odd %}"
     "{% continue %}{% endif %}{% if x > 6 %}{% break %}{% endif %}{{ x }}"
     "{% endfor %}", {}),
    ("loop-scope", "{% for i in [1, 2] %}[{{ x }}]{% set x = i %}({{ x }})"
     "{% endfor %}<{{ x }}>", {}),
    ("loop-scope-outer", "{% set x = 1 %}{% for i in [1, 2] %}{{ x }}"
     "{% if i == 1 %}{% set x = 9 %}{% endif %}{{ x }}{% endfor %}{{ x }}",
     {}),
    # Jinja's frames: a name a frame stores is that frame's from its
    # entry (undefined until set, unless an if may skip the set)
    ("scope-root-set-later", "{% for i in [1] %}[{{ x }}]{% endfor %}"
     "{% set x = 5 %}{{ x }}", {"x": 3}),
    ("scope-root-set-in-branch", "{% for i in [1] %}[{{ x }}]{% endfor %}"
     "{% if false %}{% set x = 5 %}{% endif %}{{ x }}", {"x": 3}),
    ("scope-loop-set-later", "{% for i in [1, 2] %}{% for j in [1] %}"
     "[{{ x }}]{% endfor %}{% set x = 7 %}{% endfor %}", {"x": 3}),
    ("scope-alias", "{% set t = 5 %}{% for x in [1] %}{% set t = t + 1 %}"
     "{{ t }}{% endfor %}{{ t }}", {}),
    ("scope-else-and-test", "{% for x in [] %}{% else %}{% set y = 1 %}"
     "{% endfor %}[{{ y }}]{% for x in [1] if w %}{{ x }}{% endfor %}"
     "{% set w = 0 %}", {"w": 1}),
    ("scope-set-block", "{% set b %}{% set q = 1 %}{{ q }}{% endset %}"
     "{{ b }}[{{ q }}]", {}),
    ("for-else-after-break", "{% for x in [1] %}{% continue %}{% else %}E"
     "{% endfor %}{% for x in [1, 2] %}{{ x }}{% if x == 1 %}{% break %}"
     "{% endif %}{% else %}F{% endfor %}{% for x in [1, 2] %}"
     "{% if x == 2 %}{% continue %}{% endif %}{% else %}G{% endfor %}", {}),
    ("nested-loops", "{% for i in range(3) %}{% for j in range(2) %}"
     "{{ loop.index }}{% endfor %}{{ loop.index }}{% endfor %}", {}),
    ("loop-helpers", "{% for x in 'ab' %}{{ loop.cycle('o', 'e') }}"
     "{{ loop.previtem }}{{ loop.nextitem }}{{ loop.changed(x) }}"
     "{% endfor %}{{ loop }}", {}),
    # if / elif / else, and if is not a scope
    ("if-elif", "{% if x %}a{% elif y %}b{% else %}c{% endif %}"
     "{% if not x and y or z %}d{% endif %}", {"y": 1}),
    ("if-scope", "{% if true %}{% set y = 5 %}{% endif %}{{ y }}", {}),
    # set: tuples, block set, namespace
    ("set-tuple", "{% set a, b = 1, 2 %}{{ a }}{{ b }}{% set t = (1, 2) %}"
     "{{ t }}{{ () }}{{ (1,) }}", {}),
    ("set-block", "{% set x %}inner {{ 1 + 1 }}{% endset %}[{{ x }}]", {}),
    ("namespace", "{% set ns = namespace(a=1, b=[]) %}{% for x in [1, 2, 3] %}"
     "{% set ns.a = ns.a + x %}{% endfor %}{{ ns.a }}{% set n2 = "
     "namespace() %}{% set n2.v = 1 %}{{ n2.v }}{{ n2.missing }}{{ n2 }}",
     {}),
    ("namespace-refused", "{% set x = 3 %}{% set x.y = 1 %}", {}),
    ("generation", "{% generation %}gen {{ 1 }}{% set g = 2 %}"
     "{% endgeneration %}{{ g }}", {}),
    # expressions
    ("literals", "{{ 1 if false }}|{{ none }}|{{ true }}|{{ [1, 'a'] }}|"
     "{{ {'a': 1} }}|{{ 1.0 }}|{{ 1_000 }}{{ 0x1F }}{{ 1e3 }}{{ [1, 2,] }}"
     "{{ {'a': 1,} }}", {}),
    ("strings", "{{ \"it's\" }}{{ 'a\\nb\\tc\\u00e9' }}{{ 'é' }}"
     "{{ 'con' 'cat' }}", {}),
    ("arithmetic", "{{ 1 + 2 * 3 ** 2 // 4 % 5 - -1 }}{{ 7 / 2 }}"
     "{{ 'ab' * 2 }}{{ -3 ** 2 }}{{ (-3) ** 2 }}{{ 10 // 3 }}"
     "{{ '%s-%d' % ('a', 3) }}", {}),
    ("concat", "{{ 'a' ~ 1 + 2 }}{{ 'a' ~ 1 ~ none }}{{ 1 ~ 2 * 3 }}", {}),
    ("compare", "{{ not 1 == 2 }}{{ 1 < 2 < 3 }}{{ 3 > 2 > 2 }}{{ 1 != 1 }}"
     "{{ 2 >= 2 }}{{ 1 <= 0 }}", {}),
    ("in-not-in", "{{ 'a' in 'cat' }}{{ 'q' not in ['q'] }}{{ 1 in [1] }}"
     "{{ 'k' in {'k': 1} }}", {}),
    ("logic", "{{ 0 or 'x' }}{{ 1 and 'y' }}{{ none or false }}"
     "{{ not none }}", {}),
    ("condexpr", "{{ 'a' if 1 else 'b' if 2 else 'c' }}"
     "{{ x if x is defined else 'nd' }}", {}),
    ("attr-subscript", "{{ d.a }}{{ d['a'] }}{{ d.missing }}|{{ m.0 }}"
     "{{ m[-1] }}{{ m[10] }}|{{ d['items'] }}", {"d": {"a": 1},
                                                 "m": [1, 2, 3]}),
    ("slices", "{{ m[1:] }}{{ m[:-1] }}{{ m[::2] }}{{ 'abcdef'[1:4] }}"
     "{{ m[:] }}", {"m": [1, 2, 3]}),
    ("str-methods", "{{ s.upper() }}{{ s.lower() }}{{ s.strip() }}"
     "{{ s.lstrip() }}{{ s.rstrip() }}{{ s.startswith(' H') }}"
     "{{ s.endswith('o ') }}{{ s.split() }}{{ s.split('l', 1) }}"
     "{{ s.replace('l', 'L') }}{{ s.title() }}", {"s": " Hello wOrld yo "}),
    ("dict-methods", "{{ d.get('b', 'z') }}{{ d.get('a') }}"
     "{{ d.items() | list }}{{ d.keys() | list }}{{ d.values() | list }}",
     {"d": {"a": 1}}),
    ("str-format", "{{ '{}-{x}'.format(1, x=2) }}"
     "{{ '{a}'.format_map({'a': 3}) }}", {}),
    ("globals", "{{ range(3) | list }}{{ range(1, 10, 3) | list }}"
     "{{ dict(a=1) }}{{ raise_exception is defined }}"
     "{{ strftime_now('%d %b %Y') }}", {}),
    # tests, each with is not
    ("tests", "{{ x is defined }}{{ y is defined }}{{ y is not defined }}"
     "{{ none is none }}{{ x is not none }}{{ 'a' is string }}"
     "{{ 1 is string }}{{ {} is mapping }}{{ [] is mapping }}"
     "{{ [] is iterable }}{{ 3 is iterable }}{{ 3 is number }}"
     "{{ 'a' is number }}{{ 'a' is sequence }}{{ 3 is sequence }}"
     "{{ true is true }}{{ 1 is true }}{{ false is false }}"
     "{{ 0 is not false }}{{ 1 is equalto 1 }}{{ 2 is not equalto(1) }}"
     "{{ y is iterable }}{{ y is sequence }}{{ true is number }}", {"x": 1}),
    ("tests-negated", "{{ x is not string }}{{ x is not mapping }}"
     "{{ x is not iterable }}{{ x is not number }}{{ x is not sequence }}"
     "{{ x is not true }}{{ x is not false }}{{ x is not none }}"
     "{{ x is not defined }}{{ x is not equalto [1] }}", {"x": [1]}),
    ("more-tests", "{{ 4 is divisibleby 2 }}{{ 3 is even }}{{ 'ab' is lower }}"
     "{{ 'AB' is upper }}{{ 1 is in [1] }}{{ 1 is integer }}"
     "{{ 1.0 is float }}{{ true is boolean }}{{ 2 is gt 1 }}"
     "{{ 2 is le 1 }}{{ x is sameas x }}{{ none is undefined }}",
     {"x": []}),
    ("test-precedence", "{{ 1 is equalto 1 and 2 }}{{ not x is none }}"
     "{{ x is none or 1 }}", {"x": None}),
    # filters
    ("filters-str", "{{ '  t  ' | trim }}|{{ 'xaxa' | trim('x') }}"
     "{{ 'abc' | upper }}{{ 'ABC' | lower }}{{ 'abc def' | capitalize }}"
     "{{ 'Hello wORLD-foo(bar' | title }}{{ 'x y z' | replace(' ', '_') }}"
     "{{ 'aaa' | replace('a', 'b', 2) }}", {}),
    ("filters-seq", "{{ [3, 1, 2] | first }}{{ [3, 1, 2] | last }}"
     "{{ [] | first }}{{ [] | last }}{{ 'abc' | list }}{{ x | length }}"
     "{{ x | count }}{{ ['a'] | last | upper }}", {"x": "abcd"}),
    ("filters-select", "{{ [1, 2, 3] | select('odd') | list }}"
     "{{ [1, 2, 3] | reject('odd') | list }}{{ [0, 1, ''] | select | list }}"
     "{{ [{'a': 1}, {'a': 2}, {}] | selectattr('a') | list }}"
     "{{ [{'a': 1}, {'a': 2}] | rejectattr('a', 'equalto', 1) | list }}"
     "{{ x | selectattr('type', 'equalto', 'image') | list }}",
     {"x": "text"}),
    ("filters-map", "{{ [{'a': 1}, {'a': 2}, {}] | map(attribute='a') "
     "| list }}{{ ['a', 'b'] | map('upper') | join('-') }}"
     "{{ [{'a': {'b': 'q'}}, {}] | map(attribute='a.b', default='z') "
     "| list }}", {}),
    ("filters-join", "{{ (1, 2) | join(',') }}{{ [1, 2] | join }}"
     "{{ [{'n': 'a'}, {'n': 'b'}] | join('|', attribute='n') }}", {}),
    ("filters-convert", "{{ 12 | string ~ 'x' }}{{ '42.7' | int }}"
     "{{ 'x' | int(5) }}{{ 'ff' | int(base=16) }}{{ 3.9 | int }}", {}),
    ("filters-default", "{{ u | default('d') }}{{ '' | default('e', true) }}"
     "{{ 0 | d('f', boolean=true) }}{{ none | default('g') }}"
     "{{ 'h' | d('i') }}", {}),
    ("filters-items", "{% for k, v in d | items %}{{ k }}{{ v }}{% endfor %}"
     "{% for k in u | items %}no{% endfor %}", {"d": {"a": 1, "b": 2}}),
    ("filters-indent", "{{ 'a\nb\n\nc' | indent }}|{{ 'a\nb' | indent(2, "
     "first=true) }}|{{ 'a\n\nb' | indent('>', blank=true) }}", {}),
    ("filters-tojson", "{{ {'b': 1, 'a': [1, 2]} | tojson }}"
     "{{ {'b': 'é'} | tojson(indent=2, sort_keys=true) }}"
     "{{ x | tojson(separators=(',', ':')) }}{{ 'é<>' | tojson }}",
     {"x": {"a": [1, None, True]}}),
    # Undefined
    ("undefined-renders-empty", "[{{ u }}]{{ u ~ 'a' }}{{ u | trim }}"
     "{{ u | length }}{{ u | list }}{% for x in u %}no{% endfor %}"
     "{{ u == u }}{{ u != 1 }}{{ 'a' in u }}{{ not u }}", {}),
    ("undefined-str-key", "{{ 'abc'['type'] }}|{{ ('abc'['type']) is "
     "defined }}{% for c in 'ab' %}{{ c['type'] == 'image' }}{% endfor %}",
     {}),
    ("undefined-attr-raises", "{{ u.foo }}", {}),
    ("undefined-item-raises", "{{ u['x'] }}", {}),
    ("undefined-missing-index", "{{ m[5]['role'] }}", {"m": []}),
    ("undefined-add-raises", "{{ u + 1 }}", {}),
    ("undefined-radd-raises", "{{ 1 + u }}", {}),
    ("undefined-call-raises", "{{ u() }}", {}),
    # raise_exception, errors
    ("raise-exception", "a{{ raise_exception('boom: ' ~ x) }}", {"x": 1}),
    ("type-error", "{{ 'a' + 1 }}", {}),
    ("items-of-a-list", "{% for k in [1] | items %}{% endfor %}", {}),
    # the sandbox
    ("sandbox-append", "{% set l = [1] %}{{ l.append(2) }}", {}),
    ("sandbox-update", "{{ d.update({'b': 2}) }}", {"d": {}}),
    ("sandbox-pop", "{{ m.pop() }}", {"m": [1]}),
    ("sandbox-dunder", "{{ x.__class__ }}", {"x": 1}),
    ("sandbox-format", "{{ '{0.__class__}'.format(1) }}", {}),
    ("sandbox-range", "{{ range(200000) | length }}", {}),
]


@pytest.mark.parametrize("source,context", [c[1:] for c in CONSTRUCTS],
                         ids=[c[0] for c in CONSTRUCTS])
def test_construct_renders_as_jinja(source, context):
    want, got = _oracle(source, **context), _port(source, **context)
    if want[0] == "ok":
        assert got == want
    else:
        # the same error class (jinja2's TemplateError, UndefinedError,
        # SecurityError, or Python's), and raise_exception's own message
        assert got[0] == "error" and got[1][0] == want[1][0], (got, want)
        if want[1][0] == "TemplateError":
            assert got[1][1] == want[1][1]


# -- random templates ------------------------------------------------------------

FUZZ_ATOMS = ["z", "x", "y", "1", "0", "-1", "'a'", "'b c'", "''", "none",
              "true", "false", "m", "d", "s", "[1, 2]", "[]", "{'k': 1}",
              "(1, 'a')", "m[0]", "d.k", "d['k']", "s.upper()",
              "m | length", "ns.v"]
FUZZ_OPS = ["~", "==", "!=", "and", "or", "~", "and", "or", "+", "in"]
FUZZ_FILTERS = ["trim", "string", "default('z')", "length", "upper",
                "title", "replace('a', 'q')", "tojson", "first", "list",
                "select('odd') | list", "map('string') | list"]
FUZZ_TESTS = ["defined", "none", "string", "mapping", "iterable", "number",
              "sequence", "true", "equalto 1", "odd", "undefined"]
FUZZ_CONTEXT = {"z": "zz", "x": 3, "y": "yy", "m": [1, "two", None],
                "d": {"k": "v", "n": 2}, "s": " Hello "}


def _fuzz_template(rng) -> str:
    """A random template over the subset: nested for (filters, else,
    break, continue), if/elif/else, set, set blocks, namespaces and
    comments, with random whitespace control, over expressions of every
    precedence level."""
    def expr(d=0):
        r = rng.random()
        if d > 2 or r < 0.35:
            return rng.choice(FUZZ_ATOMS)
        if r < 0.55:
            return f"({expr(d + 1)} {rng.choice(FUZZ_OPS)} {expr(d + 1)})"
        if r < 0.7:
            return f"{expr(d + 1)} | {rng.choice(FUZZ_FILTERS)}"
        if r < 0.8:
            neg = "not " if rng.random() < 0.3 else ""
            return f"({expr(d + 1)} is {neg}{rng.choice(FUZZ_TESTS)})"
        if r < 0.9:
            return f"({expr(d + 1)} if {expr(d + 1)} else {expr(d + 1)})"
        return f"not {expr(d + 1)}"

    def ws():
        return rng.choice(["", "-", "", "+"])

    def sp():
        return rng.choice(["", " ", "\n", "  \n  ", "\n\n", "\t"])

    def tag(body):
        return sp() + "{%" + ws() + f" {body} " + ws() + "%}" + sp()

    def stmt(d=0):
        r = rng.random()
        if d > 2 or r < 0.3:
            return sp() + "{{" + rng.choice(["", "-"]) + f" {expr()} " + \
                rng.choice(["", "-"]) + "}}" + sp()
        if r < 0.5:
            it = rng.choice(["m", "s", "[1, 2, 3]", "d", "range(3)", "u",
                             "z"])
            filt = rng.choice(["", "", f" if {expr(2)}"])
            ctl = rng.choice(["", "", "{% if i is odd %}{% continue %}"
                              "{% endif %}", "{% if loop.index > 1 %}"
                              "{% break %}{% endif %}"])
            els = rng.choice(["", "", tag("else") + stmt(d + 1)])
            return (tag(f"for i in {it}{filt}") + stmt(d + 1) + ctl
                    + "{{ loop.index }}" + stmt(d + 1) + els + tag("endfor"))
        if r < 0.7:
            elif_ = rng.choice(["", tag(f"elif {expr()}") + stmt(d + 1)])
            else_ = rng.choice(["", tag("else") + stmt(d + 1)])
            return (tag(f"if {expr()}") + stmt(d + 1) + elif_ + else_
                    + tag("endif"))
        if r < 0.8:
            name = rng.choice(["x", "y", "z", "m"])
            return tag(f"set {name} = {expr()}") + stmt(d + 1)
        if r < 0.85:
            return (tag(f"set {rng.choice(['x', 'z'])}") + stmt(d + 1)
                    + tag("endset") + stmt(d + 1))
        if r < 0.93:
            return tag(f"set ns.v = {expr()}") + stmt(d + 1)
        return sp() + "{#" + ws() + " c " + ws() + "#}" + sp() + stmt(d + 1)

    return ("{% set ns = namespace(v=0) %}"
            + "".join(stmt() for _ in range(rng.randint(1, 4)))
            + "{{ x }}{{ y }}{{ z }}")


@pytest.mark.parametrize("seed", range(4))
def test_random_templates_render_as_jinja(seed):
    """Seeded random templates: each renders as jinja2 renders it, or
    fails on both sides."""
    import random

    rng = random.Random(seed)
    rendered = 0
    for _ in range(150):
        source = _fuzz_template(rng)
        want = _oracle(source, **FUZZ_CONTEXT)
        got = _port(source, **FUZZ_CONTEXT)
        if want[0] == "ok":
            rendered += 1
            assert got == want, source
        else:
            assert got[0] == "error", (source, want)
    assert rendered >= 50   # the draws keep the agreement informative


UNSUPPORTED = [
    ("{% macro f() %}x{% endmacro %}{{ f() }}", "{% macro %}", 1),
    ("a\n{{ x | safe }}", "filter 'safe'", 2),
    ("\n\n{{ cycler(1, 2).next() }}", "global 'cycler'", 3),
    ("{% with a = 1 %}{{ a }}{% endwith %}", "{% with %}", 1),
    ("{% filter upper %}x{% endfilter %}", "{% filter %}", 1),
    ("{{ f(*[1]) }}", "*args", 1),
    ("{% if x is callable %}{% endif %}", "test 'callable'", 1),
    ("{{ [1] | select('callable') | list }}", "test 'callable'", 1),
    ("{{ [1] | map('abs') | list }}", "filter 'abs'", 1),
    ("{% raw %}{{ x }}{% endraw %}", "{% raw %}", 1),
    ("{% for x in [] recursive %}{% endfor %}", "recursive", 1),
    ("{% if false %}{{ x | dictsort }}{% endif %}", "filter 'dictsort'", 1),
]


@pytest.mark.parametrize("source,construct,line", UNSUPPORTED,
                         ids=[u[1] for u in UNSUPPORTED])
def test_unsupported_construct_fails_at_compile(source, construct, line):
    # jinja2 compiles each (Jinja has it); the port refuses it by name
    chat_template_utils._compile_jinja_template(source)
    with pytest.raises(ct.UnsupportedConstruct) as e:
        ct.compile_template(source)
    assert construct in str(e.value) and e.value.lineno == line


def test_unsupported_construct_fails_load(tmp_path):
    path = tmp_path / "ckpt"
    path.mkdir()
    chip_smoke._write_tokenizer(path, merges_wanted=20)
    conf = json.loads((path / "tokenizer_config.json").read_text())
    conf["chat_template"] = ("{% for m in messages %}\n{{ m.content | "
                             "wordcount }}{% endfor %}")
    (path / "tokenizer_config.json").write_text(json.dumps(conf))
    svc = VllmService(ServeConfig(
        app="vllm", model_id=str(path), device="cpu", max_seq_len=32,
        max_new_tokens=4, artifact_root=str(tmp_path / "a"),
        vllm_config=str(tmp_path / "absent.yaml")))
    with pytest.raises(ValueError, match=r"line 2: the filter 'wordcount'"):
        svc.load()


# -- template sources in a directory ------------------------------------------

CHAT = [CONVERSATIONS["turns"], CONVERSATIONS["image"],
        CONVERSATIONS["unicode"]]


def _llama_dir(path: Path) -> Path:
    path.mkdir()
    chip_smoke._write_tokenizer(path, merges_wanted=40)
    return path


def _edit_config(path: Path, **changes):
    conf = json.loads((path / "tokenizer_config.json").read_text())
    conf.update(changes)
    (path / "tokenizer_config.json").write_text(json.dumps(conf))


def _dir_case(tmp: Path, case: str) -> Path:
    if case == "llava-sp":
        path = tmp / case
        path.mkdir()
        chip_smoke._write_sp_tokenizer(path)
        (path / "chat_template.jinja").write_text(T.LLAVA15_7B + "\n")
        return path
    path = _llama_dir(tmp / case)
    if case == "config-string":
        _edit_config(path, chat_template=T.LLAMA3_8B_INSTRUCT)
    elif case == "jinja-file-over-config":
        _edit_config(path, chat_template=T.LLAMA3_8B_INSTRUCT)
        (path / "chat_template.jinja").write_bytes(
            T.LLAMA31_8B_INSTRUCT.replace("\n", "\r\n").encode())
    elif case == "config-list":
        _edit_config(path, chat_template=[
            {"name": "tool_use", "template": T.LLAMA3_8B_INSTRUCT},
            {"name": "default", "template": T.LLAMA32_11B_VISION_INSTRUCT}])
    elif case == "additional-dir":
        (path / "chat_template.jinja").write_text(T.LLAMA31_8B_INSTRUCT)
        (path / "additional_chat_templates").mkdir()
        (path / "additional_chat_templates" / "tool_use.jinja").write_text(
            T.LLAMA3_8B_INSTRUCT)
        _edit_config(path, chat_template=T.LLAVA15_7B)
    elif case == "no-default":
        (path / "additional_chat_templates").mkdir()
        (path / "additional_chat_templates" / "rag.jinja").write_text(
            T.LLAMA3_8B_INSTRUCT)
    elif case == "legacy-special-map":
        _edit_config(path, chat_template=T.LLAMA3_8B_INSTRUCT,
                     additional_special_tokens=["<|end_of_text|>"])
        (path / "special_tokens_map.json").write_text(json.dumps({
            "eos_token": {"content": "<|eot_id|>", "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "single_word": False},
            "pad_token": "<|eot_id|>",
            "additional_special_tokens": ["<|eot_id|>"]}))
    return path


@pytest.mark.parametrize("case", [
    "config-string", "jinja-file-over-config", "config-list",
    "additional-dir", "no-default", "legacy-special-map", "llava-sp"])
def test_directory_template_equals_autotokenizer(tmp_path, case):
    from transformers import AutoTokenizer

    path = _dir_case(tmp_path, case)
    hf = AutoTokenizer.from_pretrained(str(path))
    port = BpeTokenizer.from_dir(path)
    assert port.special_tokens_map == hf.special_tokens_map
    assert (port.eos_token_id, port.pad_token_id) == (hf.eos_token_id,
                                                      hf.pad_token_id)
    assert port.chat_template == hf.chat_template
    if case == "no-default":
        with pytest.raises(ValueError, match="no default"):
            hf.apply_chat_template(CHAT[0], tokenize=False)
        with pytest.raises(ValueError, match="no default"):
            port.apply_chat_template(CHAT[0])
        return
    for conv in CHAT:
        for agp in (True, False):
            want = hf.apply_chat_template(conv, tokenize=False,
                                          add_generation_prompt=agp)
            text = port.apply_chat_template(conv, add_generation_prompt=agp)
            assert text == want, (conv, agp)
            # the chat route's ids: no second BOS
            ids = port.encode(text, add_special_tokens=False)
            assert ids == hf(text, add_special_tokens=False)["input_ids"]
