"""OPTIONS.md generator from the field registry.

The torch port's copy of ``simpletuner_tpu/configuration/doc_generator.py``:
over the port's copy of the field registry it writes the same bytes as the
JAX generator (the header names the registry's original file), so one
``OPTIONS.md`` documents both packages."""

from __future__ import annotations

from typing import Dict, List

from .fields import REGISTRY, ConfigField


def generate_options_markdown() -> str:
    sections: Dict[str, List[ConfigField]] = {}
    for field in REGISTRY.fields():
        sections.setdefault(field.section, []).append(field)

    lines = [
        "# Configuration options",
        "",
        "Generated from the field registry (`simpletuner_tpu/configuration/fields.py`)",
        "— the single source of truth for CLI flags, `config.json` keys, the",
        "server's validation endpoint, and this document.",
        "",
    ]
    for section in sorted(sections):
        lines += [f"## {section}", "", "| option | type | default | description |",
                  "|---|---|---|---|"]
        for field in sections[section]:
            default = "" if field.default is None else f"`{field.default}`"
            choices = ""
            if field.choices:
                choices = f" Choices: {', '.join('`' + str(c) + '`' for c in field.choices)}."
            help_text = (field.help or "").replace("|", "\\|")
            lines.append(
                f"| `--{field.name}` | {field.type.name.lower()} | {default} | {help_text}{choices} |"
            )
        lines.append("")
    return "\n".join(lines)


def write_options_doc(path: str = "OPTIONS.md") -> str:
    content = generate_options_markdown()
    with open(path, "w") as handle:
        handle.write(content)
    return path
