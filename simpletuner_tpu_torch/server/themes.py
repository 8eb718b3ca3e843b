"""WebUI theme service: built-in + local theme discovery, CSS variables.

The torch port's copy of ``simpletuner_tpu/server/themes.py``: the same behavior.

Reference: simpletuner_sdk/server/services/theme_service.py (built-in
dark/tron/light + ~/.simpletuner/themes discovery) and routes/themes.py
(list :32, get :39, manifest :57, theme.css :73, refresh :194).

Themes here are CSS-variable palettes applied by the WebUI's
``data-theme`` attribute; local themes are ``<state_dir>/themes/<id>.json``
files carrying {name, description, variables{...}, css?}.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

_VALID_ID = re.compile(r"^[a-zA-Z0-9_-]+$")

BUILTIN_THEMES: Dict[str, Dict[str, Any]] = {
    "dark": {
        "name": "Dark",
        "description": "Default dark dashboard",
        "author": "simpletuner-tpu",
        "variables": {
            "--bg": "#101216", "--panel": "#181b21", "--line": "#2a2f39",
            "--fg": "#d8dce3", "--dim": "#8a919d", "--accent": "#6ab0f3",
            "--ok": "#7fc95c", "--err": "#e5685f",
        },
    },
    "light": {
        "name": "Light",
        "description": "Light theme for bright rooms",
        "author": "simpletuner-tpu",
        "variables": {
            "--bg": "#f6f8fa", "--panel": "#ffffff", "--line": "#d0d7de",
            "--fg": "#1f2328", "--dim": "#656d76", "--accent": "#0969da",
            "--ok": "#1a7f37", "--err": "#cf222e",
        },
    },
    "tron": {
        "name": "Tron",
        "description": "Neon grid",
        "author": "simpletuner-tpu",
        "variables": {
            "--bg": "#020a0f", "--panel": "#041720", "--line": "#0b3a4a",
            "--fg": "#9feaf9", "--dim": "#3f7f94", "--accent": "#00e5ff",
            "--ok": "#00ffa3", "--err": "#ff3860",
        },
    },
}


class ThemeStore:
    def __init__(self, state_dir: str):
        self.local_dir = os.path.join(state_dir, "themes")

    def _local(self) -> Dict[str, Dict[str, Any]]:
        themes: Dict[str, Dict[str, Any]] = {}
        if not os.path.isdir(self.local_dir):
            return themes
        for name in sorted(os.listdir(self.local_dir)):
            if not name.endswith(".json"):
                continue
            theme_id = name[:-5]
            if not _VALID_ID.match(theme_id):
                continue
            try:
                with open(os.path.join(self.local_dir, name)) as fh:
                    data = json.load(fh)
            except (ValueError, OSError):
                continue
            if isinstance(data, dict):
                themes[theme_id] = data
        return themes

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for source, table in (("builtin", BUILTIN_THEMES), ("local", self._local())):
            for theme_id, data in table.items():
                out.append({
                    "id": theme_id,
                    "name": data.get("name", theme_id),
                    "description": data.get("description", ""),
                    "author": data.get("author", ""),
                    "source": source,
                })
        return out

    def get(self, theme_id: str) -> Optional[Dict[str, Any]]:
        data = self._local().get(theme_id) or BUILTIN_THEMES.get(theme_id)
        if data is None:
            return None
        return {"id": theme_id, **data}

    def css(self, theme_id: str) -> Optional[str]:
        """Render the palette as a :root CSS-variable block plus any raw css
        the theme carries (reference routes/themes.py:73 theme.css)."""
        data = self.get(theme_id)
        if data is None:
            return None
        lines = [f"/* theme: {theme_id} */", ':root, [data-theme="%s"] {' % theme_id]
        for key, value in (data.get("variables") or {}).items():
            if re.match(r"^--[\w-]+$", str(key)) and re.match(r"^[#\w(),.% -]+$", str(value)):
                lines.append(f"  {key}: {value};")
        lines.append("}")
        extra = data.get("css")
        if isinstance(extra, str):
            lines.append(extra)
        return "\n".join(lines) + "\n"

    def save(self, theme_id: str, data: Dict[str, Any]) -> Dict[str, Any]:
        if not _VALID_ID.match(theme_id or ""):
            raise ValueError("invalid theme id")
        if theme_id in BUILTIN_THEMES:
            raise ValueError("cannot overwrite a builtin theme")
        os.makedirs(self.local_dir, exist_ok=True)
        path = os.path.join(self.local_dir, theme_id + ".json")
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2)
        return {"saved": theme_id}
