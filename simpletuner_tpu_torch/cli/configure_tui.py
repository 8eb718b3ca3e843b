"""Menu-driven configuration TUI: a curses wizard with section tabs over the
field registry, a LyCORIS builder, model-family defaults and memory presets.

The torch port's copy of ``simpletuner_tpu/cli/configure_tui.py``: the same
session, presets and tables.  Memory presets set the levers of the device
memory floor (frozen-base precision, remat policy, batch size), and
everything is driven by the port's copy of the ``FieldRegistry``, so every
field is editable with a type-aware editor.

The curses loop is a thin renderer over :class:`ConfigSession`, which is fully
scriptable — tests (and ``--answers`` automation) drive the session directly.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dataclass_field
from typing import Any, Dict, List, Optional, Tuple

from ..configuration.fields import REGISTRY, ConfigField, FieldType

# reference configure.py:100-136 default_models / default_cfg tables
DEFAULT_MODELS: Dict[str, str] = {
    "flux": "black-forest-labs/FLUX.1-dev",
    "flux2": "black-forest-labs/FLUX.2-dev",
    "sdxl": "stabilityai/stable-diffusion-xl-base-1.0",
    "pixart_sigma": "PixArt-alpha/PixArt-Sigma-XL-2-1024-MS",
    "kolors": "kwai-kolors/kolors-diffusers",
    "sd3": "stabilityai/stable-diffusion-3.5-large",
    "sd2x": "stabilityai/stable-diffusion-2-1-base",
    "sd1x": "stable-diffusion-v1-5/stable-diffusion-v1-5",
    "sana": "terminusresearch/sana-1.6b-1024px",
    "ltxvideo": "Lightricks/LTX-Video",
    "wan": "Wan-AI/Wan2.1-T2V-1.3B-Diffusers",
    "hidream": "HiDream-ai/HiDream-I1-Full",
    "auraflow": "terminusresearch/auraflow-v0.3",
    "deepfloyd": "DeepFloyd/DeepFloyd-IF-I-XL-v1.0",
    "omnigen": "Shitao/OmniGen-v1-diffusers",
    "lumina2": "Alpha-VLLM/Lumina-Image-2.0",
    "qwen_image": "Qwen/Qwen-Image",
    "hunyuanvideo": "tencent/HunyuanVideo-1.5",
    "ace_step": "ACE-Step/ACE-Step-v1-3.5B",
}

DEFAULT_CFG: Dict[str, float] = {
    "flux": 3.0, "sdxl": 4.2, "pixart_sigma": 3.4, "sd3": 5.0, "sd2x": 7.0,
    "sd1x": 7.0, "kolors": 5.0, "sana": 3.8, "ltxvideo": 4.0, "wan": 4.0,
    "hidream": 3.5, "auraflow": 3.5, "lumina2": 4.0, "qwen_image": 3.0,
}

# memory presets: the levers that set the device-memory floor on one card,
# keyed by headroom target (the JAX package's keys and settings)
MEMORY_PRESETS: Dict[str, Dict[str, Any]] = {
    "max-quality": {
        "base_model_precision": "no_change",
        "gradient_checkpointing": False,
        "description": "bf16 base, no remat — fastest, needs the most HBM",
    },
    "balanced": {
        "base_model_precision": "no_change",
        "gradient_checkpointing": True,
        "gradient_checkpointing_policy": "dots",
        "description": "bf16 base + dots remat — saves matmul outputs only",
    },
    "16g-chip": {
        "base_model_precision": "int8-quanto",
        "gradient_checkpointing": True,
        "gradient_checkpointing_policy": "full",
        "train_batch_size": 1,
        "description": "int8 frozen base + full remat — 12B-scale models on one small-memory card",
    },
}

# LyCORIS algorithm presets (reference configure.py LycorisBuilderSession
# defaults + simpletuner/lycoris_defaults.py)
LYCORIS_ALGORITHMS: Dict[str, Dict[str, Any]] = {
    "lora": {
        "algo": "lora", "multiplier": 1.0, "linear_dim": 64, "linear_alpha": 32,
        "apply_preset": {
            "target_module": ["Attention", "FeedForward"],
            "module_algo_map": {"Attention": {"factor": 16}, "FeedForward": {"factor": 8}},
        },
    },
    "lokr": {
        "algo": "lokr", "multiplier": 1.0, "linear_dim": 10000, "linear_alpha": 1, "factor": 16,
        "apply_preset": {
            "target_module": ["Attention", "FeedForward"],
            "module_algo_map": {"Attention": {"factor": 16}, "FeedForward": {"factor": 8}},
        },
    },
    "loha": {
        "algo": "loha", "multiplier": 1.0, "linear_dim": 32, "linear_alpha": 16,
        "apply_preset": {
            "target_module": ["Attention", "FeedForward"],
            "module_algo_map": {"Attention": {"factor": 16}, "FeedForward": {"factor": 8}},
        },
    },
    "ia3": {
        "algo": "ia3", "multiplier": 1.0, "linear_dim": None, "linear_alpha": None,
        "apply_preset": {"target_module": ["Attention", "FeedForward"]},
    },
    "tlora": {
        "algo": "tlora", "multiplier": 1.0, "linear_dim": 64, "linear_alpha": 32,
        "apply_preset": {"target_module": ["Attention", "FeedForward"]},
    },
    "full": {"algo": "full"},
}


class LycorisBuilder:
    """Interactive LyCORIS config builder (reference configure.py:200-560):
    algorithm choice + numeric knobs + per-module overrides, serialized to the
    ``lycoris_config`` field."""

    def __init__(self, initial: Optional[Dict[str, Any]] = None) -> None:
        self.config: Dict[str, Any] = dict(initial or LYCORIS_ALGORITHMS["lokr"])

    def algorithms(self) -> List[str]:
        return list(LYCORIS_ALGORITHMS)

    def set_algorithm(self, algo: str) -> None:
        if algo not in LYCORIS_ALGORITHMS:
            raise ValueError(f"unknown LyCORIS algorithm {algo!r}; known: {self.algorithms()}")
        overrides = self.config.get("apply_preset")
        self.config = dict(LYCORIS_ALGORITHMS[algo])
        if overrides:
            self.config["apply_preset"] = overrides

    def set_option(self, key: str, value: Any) -> None:
        self.config[key] = value

    def set_module_override(self, module: str, options: Dict[str, Any]) -> None:
        preset = self.config.setdefault("apply_preset", {"name_algo_map": {}})
        preset.setdefault("name_algo_map", {})[module] = dict(options)

    def remove_module_override(self, module: str) -> None:
        mapping = self.config.get("apply_preset", {}).get("name_algo_map", {})
        mapping.pop(module, None)

    def validate(self) -> Optional[str]:
        if "algo" not in self.config:
            return "lycoris config needs an 'algo'"
        if self.config["algo"] not in LYCORIS_ALGORITHMS:
            return f"unknown algo {self.config['algo']!r}"
        return None

    def build(self) -> Dict[str, Any]:
        error = self.validate()
        if error:
            raise ValueError(error)
        return dict(self.config)


@dataclass
class SectionView:
    name: str
    fields: List[ConfigField] = dataclass_field(default_factory=list)


class ConfigSession:
    """Registry-driven config state: the scriptable core of the wizard."""

    def __init__(self) -> None:
        self.values: Dict[str, Any] = {}
        self.unknown: Dict[str, Any] = {}
        self.loaded_path: Optional[str] = None

    # ---- structure -----------------------------------------------------------------
    def sections(self) -> List[SectionView]:
        by_name: Dict[str, SectionView] = {}
        for field in REGISTRY.fields():
            by_name.setdefault(field.section, SectionView(field.section)).fields.append(field)
        return list(by_name.values())

    def search(self, query: str) -> List[ConfigField]:
        query = query.lower()
        return [
            f for f in REGISTRY.fields()
            if query in f.name.lower() or query in (f.help or "").lower()
        ]

    # ---- values --------------------------------------------------------------------
    def get(self, name: str) -> Any:
        field = REGISTRY.get(name)
        if field is None:
            return self.unknown.get(name)
        return self.values.get(field.name, field.default)

    def set(self, name: str, raw: Any) -> Optional[str]:
        """Coerce + validate; returns an error message or None on success."""
        field = REGISTRY.get(name)
        if field is None:
            self.unknown[name] = raw
            return None
        if raw is None or raw == "":
            self.values.pop(field.name, None)
            return None
        try:
            value = field.coerce(raw)
        except (ValueError, TypeError) as exc:
            return str(exc)
        if field.choices and value not in field.choices:
            return f"{field.name}: {value!r} not in {list(field.choices)}"
        if field.validator:
            error = field.validator(value)
            if error:
                return error
        self.values[field.name] = value
        return None

    def is_modified(self, name: str) -> bool:
        field = REGISTRY.get(name)
        return bool(field and field.name in self.values)

    # ---- presets -------------------------------------------------------------------
    def apply_family(self, family: str) -> None:
        """Model-family quickstart: default hub path + CFG (reference
        configure.py default_models/default_cfg)."""
        from ..models.registry import ModelRegistry

        ModelRegistry.metadata(family)  # raises on unknown family
        self.set("model_family", family)
        if family in DEFAULT_MODELS and not self.is_modified("pretrained_model_name_or_path"):
            self.set("pretrained_model_name_or_path", DEFAULT_MODELS[family])
        if family in DEFAULT_CFG and not self.is_modified("validation_guidance"):
            self.set("validation_guidance", DEFAULT_CFG[family])

    def apply_memory_preset(self, preset: str) -> None:
        if preset not in MEMORY_PRESETS:
            raise ValueError(f"unknown memory preset {preset!r}; known: {list(MEMORY_PRESETS)}")
        for key, value in MEMORY_PRESETS[preset].items():
            if key == "description":
                continue
            error = self.set(key, value)
            if error:
                raise ValueError(error)

    def apply_lycoris(self, builder: LycorisBuilder) -> None:
        self.set("lora_type", "lycoris")
        self.values["lycoris_config"] = builder.build()

    # ---- io ------------------------------------------------------------------------
    def load(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as handle:
            payload = json.load(handle)
        if not isinstance(payload, dict):
            raise ValueError(f"{path} is not a JSON object")
        self.values = {}
        self.unknown = {}
        for key, value in payload.items():
            field = REGISTRY.get(key)
            if field is None:
                self.unknown[key] = value
            elif isinstance(value, (dict, list)) and field.type == FieldType.STR:
                # structured values for path-or-inline fields (e.g. an inline
                # lycoris_config dict) pass through unstringified
                self.values[field.name] = value
            else:
                self.values[field.name] = field.coerce(value)
        self.loaded_path = path

    def to_dict(self) -> Dict[str, Any]:
        data = dict(self.unknown)
        data.update(self.values)
        return data

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as handle:
            json.dump(self.to_dict(), handle, indent=2, sort_keys=True)
        return path

    def validate_all(self) -> List[str]:
        """Cross-check the assembled config through TrainingConfig."""
        from ..configuration import TrainingConfig

        try:
            TrainingConfig(self.to_dict())
        except Exception as exc:
            return [str(exc)]
        return []

    def summary(self) -> str:
        lines = [f"{name} = {value!r}" for name, value in sorted(self.values.items())]
        if self.unknown:
            lines.append(f"(+{len(self.unknown)} passthrough keys)")
        return "\n".join(lines) or "(all defaults)"


# -------------------------------------------------------------------------------------
# curses renderer
# -------------------------------------------------------------------------------------


class CursesWizard:
    """Tabbed section browser over a :class:`ConfigSession`.

    Keys: ←/→ switch section · ↑/↓ move · enter edit · space toggle bool ·
    f family quickstart · m memory preset · L LyCORIS builder · / search ·
    w write config · q quit.
    """

    def __init__(self, session: Optional[ConfigSession] = None, output_path: str = "config/config.json"):
        self.session = session or ConfigSession()
        self.output_path = output_path
        self.tab = 0
        self.row = 0
        self.status = "enter=edit  space=toggle  f=family  m=memory  L=lycoris  /=search  w=write  q=quit"
        self.filtered: Optional[List[ConfigField]] = None

    # ---- pure helpers (unit-testable without a terminal) ---------------------------
    def current_fields(self) -> List[ConfigField]:
        if self.filtered is not None:
            return self.filtered
        sections = self.session.sections()
        return sections[self.tab % len(sections)].fields

    def move(self, delta: int) -> None:
        fields = self.current_fields()
        if fields:
            self.row = (self.row + delta) % len(fields)

    def switch_tab(self, delta: int) -> None:
        self.filtered = None
        sections = self.session.sections()
        self.tab = (self.tab + delta) % len(sections)
        self.row = 0

    def set_search(self, query: str) -> None:
        self.filtered = self.session.search(query) if query else None
        self.row = 0

    def edit_current(self, raw: str) -> Optional[str]:
        fields = self.current_fields()
        if not fields:
            return None
        return self.session.set(fields[self.row].name, raw)

    def toggle_current(self) -> None:
        fields = self.current_fields()
        if not fields:
            return
        field = fields[self.row]
        if field.type == FieldType.BOOL:
            self.session.set(field.name, not bool(self.session.get(field.name)))

    # ---- rendering -----------------------------------------------------------------
    def _draw(self, screen) -> None:
        import curses

        screen.erase()
        rows, cols = screen.getmaxyx()
        sections = self.session.sections()
        header = ""
        for i, section in enumerate(sections):
            label = f" {section.name} "
            if i == self.tab % len(sections) and self.filtered is None:
                label = f"[{section.name}]"
            if len(header) + len(label) < cols - 1:
                header += label
        screen.addnstr(0, 0, header, cols - 1, curses.A_BOLD)

        fields = self.current_fields()
        top = max(0, self.row - (rows - 5))
        for i, field in enumerate(fields[top : top + rows - 4]):
            idx = top + i
            value = self.session.get(field.name)
            marker = "*" if self.session.is_modified(field.name) else " "
            line = f"{marker} {field.name:<40} = {value!r}"
            attr = curses.A_REVERSE if idx == self.row else curses.A_NORMAL
            screen.addnstr(2 + i, 0, line, cols - 1, attr)
        screen.addnstr(rows - 2, 0, self.status[: cols - 1], cols - 1)
        screen.refresh()

    def _prompt(self, screen, label: str, default: str = "") -> str:
        import curses

        rows, cols = screen.getmaxyx()
        curses.echo()
        screen.addnstr(rows - 1, 0, f"{label} ", cols - 1)
        screen.clrtoeol()
        screen.refresh()
        try:
            raw = screen.getstr(rows - 1, len(label) + 1, 512).decode("utf-8", "replace")
        finally:
            curses.noecho()
        return raw.strip() or default

    def run(self) -> Optional[str]:
        import curses

        return curses.wrapper(self._loop)

    def _loop(self, screen) -> Optional[str]:
        import curses

        curses.curs_set(0)
        while True:
            self._draw(screen)
            key = screen.getch()
            if key in (ord("q"), 27):
                return None
            if key == curses.KEY_RIGHT:
                self.switch_tab(1)
            elif key == curses.KEY_LEFT:
                self.switch_tab(-1)
            elif key == curses.KEY_DOWN:
                self.move(1)
            elif key == curses.KEY_UP:
                self.move(-1)
            elif key == ord(" "):
                self.toggle_current()
            elif key == ord("/"):
                self.set_search(self._prompt(screen, "search:"))
            elif key == ord("f"):
                from ..models.registry import ModelRegistry

                family = self._prompt(screen, f"family ({', '.join(ModelRegistry.families()[:8])}…):")
                if family:
                    try:
                        self.session.apply_family(family)
                        self.status = f"applied {family} defaults"
                    except KeyError as exc:
                        self.status = str(exc)
            elif key == ord("m"):
                preset = self._prompt(screen, f"memory preset ({', '.join(MEMORY_PRESETS)}):")
                if preset:
                    try:
                        self.session.apply_memory_preset(preset)
                        self.status = f"applied memory preset {preset}"
                    except ValueError as exc:
                        self.status = str(exc)
            elif key == ord("L"):
                builder = LycorisBuilder(self.session.get("lycoris_config"))
                algo = self._prompt(screen, f"lycoris algo ({', '.join(builder.algorithms())}):", "lokr")
                try:
                    builder.set_algorithm(algo)
                    factor = self._prompt(screen, "lokr factor:", str(builder.config.get("factor", "")))
                    if factor:
                        builder.set_option("factor", int(factor))
                    self.session.apply_lycoris(builder)
                    self.status = f"lycoris config set ({algo})"
                except ValueError as exc:
                    self.status = str(exc)
            elif key in (curses.KEY_ENTER, 10, 13):
                fields = self.current_fields()
                if fields:
                    field = fields[self.row]
                    hint = f" {list(field.choices)}" if field.choices else ""
                    raw = self._prompt(screen, f"{field.name}{hint} =", "")
                    if raw:
                        error = self.session.set(field.name, raw)
                        self.status = error or f"set {field.name}"
            elif key == ord("w"):
                errors = self.session.validate_all()
                if errors:
                    self.status = f"validation: {errors[0][:120]}"
                    continue
                path = self._prompt(screen, "write to:", self.output_path)
                self.session.save(path)
                self.status = f"wrote {path}"
                return path


def run_tui(output_path: str = "config/config.json", load: Optional[str] = None) -> Optional[str]:
    session = ConfigSession()
    if load and os.path.exists(load):
        session.load(load)
    wizard = CursesWizard(session, output_path)
    return wizard.run()
