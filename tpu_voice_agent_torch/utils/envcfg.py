"""The two-level ``.env`` cascade of the services' ``main``.

Port of ``tpu_voice_agent/utils/envcfg.py`` (``_parse_dotenv``,
``load_env_cascade``). The explicit process environment wins, then an
app-local ``.env``, then the repo-root ``.env``: the merged lines go into
``os.environ`` without overwriting a name the process already has. The
brain's and the voice service's ``main`` call ``load_env_cascade`` before
they read any knob, so a knob set only in the repo-root ``.env`` is served
or refused at boot like one set in the environment.
"""

from __future__ import annotations

import os
from pathlib import Path

# the checkout's root: the directory above the package
REPO_ROOT = Path(__file__).resolve().parents[2]


def _parse_dotenv(path: Path) -> dict[str, str]:
    """``KEY=value`` lines of ``path`` (none when it is not a file): blank
    lines, ``#`` comments and lines without ``=`` skipped, the value
    stripped of surrounding whitespace and quotes."""
    out: dict[str, str] = {}
    if not path.is_file():
        return out
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        out[key.strip()] = val.strip().strip('"').strip("'")
    return out


def load_env_cascade(app_dir: str | Path | None = None,
                     root: str | Path | None = None) -> dict[str, str]:
    """Merge ``<root>/.env``, then ``<app_dir>/.env``, into ``os.environ``
    without overwriting what is set. ``root`` defaults to the checkout's
    root (``REPO_ROOT``). Returns the merged file values."""
    merged = _parse_dotenv(Path(root if root is not None else REPO_ROOT) / ".env")
    if app_dir is not None:
        merged.update(_parse_dotenv(Path(app_dir) / ".env"))
    for k, v in merged.items():
        os.environ.setdefault(k, v)
    return merged
