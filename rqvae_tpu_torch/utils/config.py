"""Hierarchical YAML configs without PyYAML.

Port of rqvae_tpu/utils/config.py: `env_flag`, the attribute dict
`Config` (with `to_yaml`), `merge`, `from_dotlist`, `load_config`,
`is_stage1_arch`, the layered defaults (`augment_arch_defaults`,
`augment_defaults`, `augment_dist_defaults`) and `config_setup`. The card's
machine has no PyYAML, so `load_config` reads the YAML subset that the
repository's configs and `yaml.safe_dump` write, with PyYAML's (YAML 1.1)
resolution of plain scalars:

  - block mappings (`key: value`, `key:` then a more indented block);
  - block sequences (`- item`, also at the indentation of their key), whose
    items are scalars, flow sequences or mappings;
  - flow sequences on one line (`[ 8, 8, 2 ]`, nested);
  - null (`null`, `~`, nothing), booleans (`true`, `True`, `no`, ...),
    ints (decimal, 0x, 0o, 0b, leading-0 octal, `_` separators), floats
    that have a dot (`4.0e-5`; PyYAML reads `4e-5` as a string), `.inf`,
    `.nan`;
  - single- and double-quoted and plain strings, and `#` comments.

  - `{}`, the empty mapping, as a whole value.

Anything else (other flow mappings, anchors, aliases, tags, block scalars
`|` / `>`, multi-line scalars, documents, tabs, dates) raises ValueError
naming the line. `Config.to_yaml` writes only this subset, so that both
`parse_yaml` and PyYAML's safe_load read back the dict it was given.
`augment_dist_defaults` and `config_setup` are the training CLIs' (JAX
rqvae_tpu/utils/config.py:246, :267).
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Iterable, Mapping


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env var: '0', 'false', 'no', 'off' and '' are False."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("", "0", "false", "no", "off")


class Config(dict):
    """dict with attribute access and recursive wrapping."""

    def __init__(self, data: Mapping | None = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for k, v in data.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        del self[key]

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def copy(self) -> "Config":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def to_yaml(self) -> str:
        """The config as YAML of the subset parse_yaml reads."""
        return "".join(_yaml_lines(self.to_dict(), 0))


def _yaml_scalar(v) -> str:
    """A scalar as parse_yaml and yaml.safe_load both read it back."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:  # PyYAML reads 4e-05 as a string; 4.0e-05 as a float
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(v, str):
        try:
            plain = re.fullmatch(r"[A-Za-z0-9_./][A-Za-z0-9_./+\-]*", v) and _resolve_plain(v, 0) == v
        except ValueError:  # a date or a base-60 number
            plain = False
        return v if plain else json.dumps(v)
    if hasattr(v, "item"):  # a numpy scalar
        return _yaml_scalar(v.item())
    raise ValueError(f"to_yaml: {type(v).__name__} {v!r} is outside the YAML subset")


def _is_flow(v) -> bool:
    return isinstance(v, (list, tuple)) and all(not isinstance(x, Mapping) and (not isinstance(x, (list, tuple))
                                                                               or _is_flow(x)) for x in v)


def _yaml_flow(v) -> str:
    return "[" + ", ".join(_yaml_flow(x) if isinstance(x, (list, tuple)) else _yaml_scalar(x) for x in v) + "]"


def _yaml_value(v, indent: int):
    """(text after `key:` or `-`, the block lines under it)."""
    if isinstance(v, Mapping):
        return ("", list(_yaml_lines(v, indent + 2))) if v else (" {}", [])
    if isinstance(v, (list, tuple)):
        if _is_flow(v):
            return " " + _yaml_flow(v), []
        lines = []
        for x in v:
            text, block = _yaml_value(x, indent + 2)
            lines.append(" " * (indent + 2) + "-" + text + "\n")
            lines.extend(block)
        return "", lines
    return " " + _yaml_scalar(v), []


def _yaml_lines(d: Mapping, indent: int):
    for k, v in d.items():
        text, block = _yaml_value(v, indent)
        yield " " * indent + _yaml_scalar(k) + ":" + text + "\n"
        yield from block


def merge(base: Mapping, override: Mapping) -> Config:
    """Recursive merge; `override` wins. Lists are replaced, not concatenated."""
    out = Config(base).copy()
    for k, v in override.items():
        if k in out and isinstance(out[k], Config) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_UNSUPPORTED_START = "{}&*!|>%@`?"


class _Line:
    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _fail(line_no: int, what: str):
    raise ValueError(f"line {line_no}: {what} is outside the YAML subset load_config reads")


def _resolve_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    if s[0] in "+-":
        s = s[1:]
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s != "0" and s.startswith("0"):
        return sign * int(s, 8)
    return sign * int(s)


def _resolve_plain(s: str, line_no: int):
    """A plain scalar as yaml.safe_load resolves it."""
    if _NULL.match(s):
        return None
    if _TRUE.match(s):
        return True
    if _FALSE.match(s):
        return False
    if _INT.match(s):
        return _resolve_int(s)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    if _SEXAGESIMAL.match(s):
        _fail(line_no, f"the base-60 number {s!r}")
    if _TIMESTAMP.match(s):
        _fail(line_no, f"the date {s!r}")
    return s


def _strip_comment(text: str) -> str:
    """text without a `#` comment (one at the start or after a blank, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1 : i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [,-:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _quoted(text: str, i: int, line_no: int) -> tuple[str, int]:
    """The quoted scalar starting at text[i] (a quote) -> (value, index after it)."""
    q = text[i]
    out = []
    i += 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            n = {"x": 2, "u": 4, "U": 8}.get(e)
            hexa = text[i + 2 : i + 2 + n] if n else ""
            if not n or len(hexa) != n or any(h not in "0123456789abcdefABCDEF" for h in hexa):
                _fail(line_no, f"the escape {text[i:i + 2]!r}")
            out.append(chr(int(hexa, 16)))
            i += 2 + n
            continue
        out.append(c)
        i += 1
    _fail(line_no, "a quoted string that does not end on its line")


def _flow(text: str, i: int, line_no: int) -> tuple[list, int]:
    """The flow sequence starting at text[i] == '[' -> (list, index after ']')."""
    items: list = []
    i += 1
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            _fail(line_no, "a flow sequence that does not end on its line")
        c = text[i]
        if c == "]" and not items:
            return items, i + 1
        if c == "[":
            value, i = _flow(text, i, line_no)
        elif c in "'\"":
            value, i = _quoted(text, i, line_no)
        elif c in _UNSUPPORTED_START or c == ",":
            _fail(line_no, f"{c!r} in a flow sequence")
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                if text[j] in "[{}":
                    _fail(line_no, f"{text[j]!r} inside a plain scalar of a flow sequence")
                j += 1
            value, i = _resolve_plain(text[i:j].strip(), line_no), j
        items.append(value)
        while i < len(text) and text[i] == " ":
            i += 1
        if i < len(text) and text[i] == ",":
            i += 1
            continue
        if i < len(text) and text[i] == "]":
            return items, i + 1
        _fail(line_no, "a flow sequence item followed by neither ',' nor ']'")


def _value(text: str, line_no: int):
    """A scalar or flow sequence that is the whole of `text`."""
    text = text.strip()
    if not text:
        return None
    c = text[0]
    if text == "{}":
        return {}
    if c == "[":
        value, end = _flow(text, 0, line_no)
    elif c in "'\"":
        value, end = _quoted(text, 0, line_no)
    elif c in _UNSUPPORTED_START or (c == "-" and text[1:2] in ("", " ")) or text.startswith(("---", "...")):
        _fail(line_no, f"{text!r}")
    elif ": " in text or text.endswith(":"):
        _fail(line_no, f"a mapping inside the value {text!r}")
    else:
        return _resolve_plain(text, line_no)
    if text[end:].strip():
        _fail(line_no, f"{text[end:].strip()!r} after a value")
    return value


def _split_key(text: str, line_no: int):
    """`key: rest` -> (key, rest), or None when the line holds no key."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, line_no)
        rest = text[end:]
        if not (rest.startswith(": ") or rest == ":"):
            return None
        return key, rest[1:].strip()
    m = re.match(r"^([^\s#\[\]{},][^#]*?)\s*:(?:\s+(.*))?$", text)
    if m is None:
        return None
    key = m.group(1)
    if ": " in key:
        return None
    return _resolve_plain(key, line_no), (m.group(2) or "").strip()


def _block(lines: list, i: int, indent: int) -> tuple[Any, int]:
    """The block node whose lines start at lines[i], at `indent`."""
    line = lines[i]
    if line.text == "-" or line.text.startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines: list, i: int, parent_indent: int, allow_same_indent_seq: bool) -> tuple[Any, int]:
    """The value of `key:` or `-` with nothing after it: the block that
    follows, more indented (or a sequence at the key's own indentation)."""
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > parent_indent:
            return _block(lines, i, nxt.indent)
        if allow_same_indent_seq and nxt.indent == parent_indent and (nxt.text == "-" or nxt.text.startswith("- ")):
            return _sequence(lines, i, parent_indent)
    return None, i


def _mapping(lines: list, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        if line.text == "-" or line.text.startswith("- "):
            break
        split = _split_key(line.text, line.no)
        if split is None:
            _fail(line.no, f"{line.text!r} (not `key: value`)")
        key, rest = split
        i += 1
        if rest:
            out[key] = _value(rest, line.no)
            if i < len(lines) and lines[i].indent > indent:
                _fail(lines[i].no, "a value continued on the next line")
        else:
            out[key], i = _nested(lines, i, indent, allow_same_indent_seq=True)
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].no, "an indentation that matches no open block")
    return out, i


def _sequence(lines: list, i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(lines) and lines[i].indent == indent and (lines[i].text == "-" or lines[i].text.startswith("- ")):
        line = lines[i]
        rest = line.text[1:].lstrip(" ")
        if not rest:
            value, i = _nested(lines, i + 1, indent, allow_same_indent_seq=False)
        elif _split_key(rest, line.no) is not None or rest.startswith("- "):
            # an inline block (`- key: value`, `- - x`): its lines start at the item's column
            lines[i] = _Line(line.no, indent + len(line.text) - len(rest), rest)
            value, i = _block(lines, i, lines[i].indent)
        else:
            value, i = _value(rest, line.no), i + 1
            if i < len(lines) and lines[i].indent > indent:
                _fail(lines[i].no, "a value continued on the next line")
        out.append(value)
    return out, i


def parse_yaml(text: str):
    """The YAML subset of the module docstring -> the object yaml.safe_load gives."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or "\t" in raw[: len(raw) - len(body)]:
            _fail(no, "a tab in the indentation")
        body = _strip_comment(body)
        if not body:
            continue
        if no == 1 and body.startswith("%"):
            _fail(no, "a directive")
        if body in ("---", "...") or body.startswith(("--- ", "... ")):
            _fail(no, "a document marker")
        lines.append(_Line(no, len(raw) - len(raw.lstrip(" ")), body))
    if not lines:
        return None
    if not (lines[0].text == "-" or lines[0].text.startswith("- ") or _split_key(lines[0].text, lines[0].no)):
        value = _value(lines[0].text, lines[0].no)
        if len(lines) > 1:
            _fail(lines[1].no, "a second top-level node")
        return value
    value, i = _block(lines, 0, lines[0].indent)
    if i < len(lines):
        _fail(lines[i].no, f"{lines[i].text!r} at an indentation outside the top-level block")
    return value


def _parse_value(text: str):
    """A dotlist value: a scalar or flow sequence, else the text itself."""
    try:
        return _value(text, 1)
    except ValueError:
        return text


def from_dotlist(items: Iterable[str]) -> Config:
    """'a.b.c=1 x=[2,3]' style overrides (OmegaConf.from_dotlist equivalent)."""
    cfg = Config()
    for item in items:
        if "=" not in item:
            raise ValueError(f"dotlist entry must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _parse_value(value)
    return cfg


def load_config(config_path: str) -> Config:
    with open(config_path) as f:
        text = f.read()
    try:
        data = parse_yaml(text)
    except ValueError as e:
        raise ValueError(f"{config_path}: {e}") from None
    if data is not None and not isinstance(data, dict):
        raise ValueError(f"{config_path}: the top level is not a mapping")
    return Config(data or {})


def is_stage1_arch(arch_type: str) -> bool:
    return "transformer" not in arch_type


# ---------------------------------------------------------------------------
# layered defaults (the reference's rqvae/utils/config.py:29-129)
# ---------------------------------------------------------------------------

RQVAE_ARCH_DEFAULTS = {
    "ema": None,
    "hparams": {
        "loss_type": "l1",
        "restart_unused_codes": False,
        "use_padding_idx": False,
        "masked_dropout": 0.0,
    },
    "checkpointing": False,
}

ATTENTION_BLOCK_DEFAULTS = {
    "embed_dim": None,
    "n_head": None,
    "mlp_bias": True,
    "attn_bias": True,
    "attn_pdrop": 0.0,
    "resid_pdrop": 0.1,
    "gelu": "v1",
}

RQTRANSFORMER_DEFAULTS = {
    "type": "rq-transformer",
    "ema": None,
    "ar_hierarchy": None,
    "vocab_size": None,
    "block_size": None,
    "vocab_size_cond": 0,
    "block_size_cond": 0,
    "embed_dim": None,
    "input_embed_dim": None,
    "use_padding_emb": False,
    "input_emb_vqvae": False,
    "head_emb_vqvae": False,
    "scaled_head_emb_vqvae": False,
    "cumsum_depth_ctx": False,
    "shared_tok_emb": False,
    "embd_pdrop": 0.0,
    "body": {"n_layer": None, "block": ATTENTION_BLOCK_DEFAULTS},
    "head": {"n_layer": None, "block": ATTENTION_BLOCK_DEFAULTS},
    "shared_cls_emb": False,
}


def augment_arch_defaults(arch_config: Config) -> Config:
    if arch_config.type == "rq-vae":
        return merge(RQVAE_ARCH_DEFAULTS, arch_config)
    elif arch_config.type == "rq-transformer":
        defaults = Config(RQTRANSFORMER_DEFAULTS).copy()
        # embed_dim reaches the body and head blocks (the reference's
        # RQTransformerConfig.create)
        defaults.body.block.embed_dim = arch_config.embed_dim
        defaults.head.block.embed_dim = arch_config.embed_dim
        return merge(defaults, arch_config)
    else:
        raise NotImplementedError(arch_config.type)


def augment_optimizer_defaults(optim_config: Config) -> Config:
    defaults = {
        "type": "adamW",
        "max_gn": None,
        "warmup": {
            "mode": "linear",
            "start_from_zero": bool(optim_config.warmup.epoch > 0),
        },
    }
    return merge(defaults, optim_config)


def augment_defaults(config: Config) -> Config:
    defaults = Config(
        {
            "arch": augment_arch_defaults(config.arch),
            "dataset": {"transform": {"type": None}},
            "optimizer": augment_optimizer_defaults(config.optimizer),
            "experiment": {"test_freq": 10, "amp": False},
        }
    )

    if "gan" in config:
        gan_opt = merge(defaults.optimizer, config.gan.disc.get("optimizer", {}))
        defaults.gan = Config({"disc": {"optimizer": gan_opt}})

    if not is_stage1_arch(config.arch.type):
        # stage 2: the stage-1 arch config comes from the config.yaml beside
        # the vqvae checkpoint (the reference's config.py:91-107)
        model_aux_path = config.vqvae.ckpt
        model_aux_config_path = os.path.join(os.path.dirname(model_aux_path), "config.yaml")
        stage1_arch_config = load_config(model_aux_config_path).arch

        config = config.copy()
        config.vqvae = stage1_arch_config
        config.vqvae.ckpt = model_aux_path

        defaults.vqvae = augment_arch_defaults(config.vqvae)
        defaults.arch.vocab_size = config.dataset.vocab_size
        defaults.experiment.sample = {"top_k": None, "top_p": None}

        if config.get("loss", {}).get("type", "") == "soft_target_cross_entropy":
            defaults.loss = {"temp": 1.0, "stochastic_codes": False}
        else:
            defaults.loss = {
                "type": "cross_entropy",
                "temp": 1.0,
                "stochastic_codes": False,
            }

    return merge(defaults, config)


def augment_dist_defaults(config: Config, num_devices: int) -> Config:
    """Gradient-accumulation math (the reference's config.py:114-129):
    num_devices processes of experiment.batch_size each make one world
    batch; total_batch_size (default: the world batch) must be a multiple
    of it, and optimizer.grad_accm_steps is the quotient."""
    config = config.copy()
    world_batch_size = num_devices * config.experiment.batch_size
    total_batch_size = config.experiment.get("total_batch_size", world_batch_size)
    if total_batch_size % world_batch_size != 0:
        raise ValueError("total batch size must be divisible by world batch size")
    config.optimizer.grad_accm_steps = total_batch_size // world_batch_size
    config.experiment.total_batch_size = total_batch_size
    return config


def config_setup(args, num_devices: int, config_path: str, extra_args=()) -> Config:
    """The training CLIs' config (the reference's config.py:132-162): for
    --eval the file with its defaults (and test_batch_size, seed); for
    --resume the file as written by the run (its num_devices must equal
    this run's); else the file merged with the key=value extra_args, the
    defaults, the accumulation math, the seed and the runtime record."""
    if getattr(args, "eval", False):
        config = augment_defaults(load_config(config_path))
        if getattr(args, "test_batch_size", None):
            config.experiment.batch_size = args.test_batch_size
        if "seed" not in config:
            config.seed = args.seed
    elif getattr(args, "resume", False):
        config = load_config(config_path)
        if num_devices != config.runtime.num_devices:
            raise ValueError("num_devices not identical to the resuming config")
        config.runtime = {"args": vars(args), "num_devices": num_devices}
    else:
        config = load_config(getattr(args, "model_config", config_path))
        config = merge(config, from_dotlist(extra_args))
        config = augment_defaults(config)
        config = augment_dist_defaults(config, num_devices)
        config.seed = args.seed
        config.runtime = {"args": vars(args), "extra_config": from_dotlist(extra_args), "num_devices": num_devices}
    return config
