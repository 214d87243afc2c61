"""The port's ``.env`` cascade (``utils/envcfg.py``) against the JAX
package's, and its place in both services' ``main``: called first, so a
knob set only in the repo-root ``.env`` reaches the refusals at boot.

The tests never write the checkout's own ``.env``: the loader is pointed at
a temporary root (``root=``, or ``REPO_ROOT`` patched for ``main``).
"""

import os

import pytest

from tpu_voice_agent.utils.envcfg import _parse_dotenv as j_parse
from tpu_voice_agent_torch.services import brain, voice
from tpu_voice_agent_torch.utils import envcfg

DOTENV = """
# comment line
BRAIN_BACKEND=engine:test-tiny
  KV_QUANT = int8
QUOTED="a b c"
SINGLE='x=y'
EMPTY=
no equals sign here
=orphan
URL=http://127.0.0.1:8090/parse?a=b
   # indented comment
SPACED_VAL =  padded value
"""


def _fresh(monkeypatch, *names):
    """Unset ``names`` for the test; whatever the cascade sets goes too."""
    for name in names:
        monkeypatch.setenv(name, "placeholder")
        monkeypatch.delenv(name)


def test_dotenv_parses_as_jax_does(tmp_path):
    p = tmp_path / ".env"
    p.write_text(DOTENV)
    assert envcfg._parse_dotenv(p) == j_parse(p)
    assert envcfg._parse_dotenv(p)["KV_QUANT"] == "int8"
    assert envcfg._parse_dotenv(p)["QUOTED"] == "a b c"
    assert envcfg._parse_dotenv(tmp_path / "missing") == j_parse(tmp_path / "missing") == {}


def test_the_process_environment_wins(tmp_path, monkeypatch):
    """Root ``.env`` < app ``.env`` < the process environment."""
    (tmp_path / ".env").write_text("TVA_A=root\nTVA_B=root\nTVA_C=root\n")
    app = tmp_path / "app"
    app.mkdir()
    (app / ".env").write_text("TVA_B=app\nTVA_C=app\n")
    _fresh(monkeypatch, "TVA_A", "TVA_B", "TVA_C")
    monkeypatch.setenv("TVA_C", "process")
    merged = envcfg.load_env_cascade(app_dir=app, root=tmp_path)
    assert merged == {"TVA_A": "root", "TVA_B": "app", "TVA_C": "app"}
    assert (os.environ["TVA_A"], os.environ["TVA_B"], os.environ["TVA_C"]) == (
        "root", "app", "process")


def test_the_default_root_is_the_checkout():
    """As in JAX: the directory above the package."""
    import tpu_voice_agent.utils.envcfg as jenv
    from pathlib import Path

    assert envcfg.REPO_ROOT == Path(jenv.__file__).resolve().parents[2]


@pytest.mark.parametrize("name,value", [
    ("TENANT_CLASSES", "premium:0"),  # a zero weight: malformed
    ("BRAIN_MODEL", "/models/intent-8b"),  # item 8
    ("RADIX_SESSIONS", "lots"),
])
def test_a_knob_only_in_the_dotenv_is_refused_at_brain_boot(tmp_path, monkeypatch, name, value):
    (tmp_path / ".env").write_text(f"{name}={value}\n")
    _fresh(monkeypatch, name)
    monkeypatch.setattr(envcfg, "REPO_ROOT", tmp_path)
    served = []
    monkeypatch.setattr(brain, "make_server", lambda *a, **k: served.append(1))
    with pytest.raises(ValueError, match=name):
        brain.main()
    assert not served and os.environ[name] == value


def test_a_served_knob_only_in_the_dotenv_reaches_the_brain(tmp_path, monkeypatch):
    """``TENANT_CLASSES`` and ``RADIX_SESSIONS`` from the ``.env`` reach the
    batched engine parser the brain's ``main`` builds."""
    (tmp_path / ".env").write_text(
        "BRAIN_BACKEND=engine:test-tiny\nBRAIN_DEVICE=cpu\nBRAIN_BATCH=2\nBRAIN_PAGED=1\n"
        "RADIX_ENABLE=1\nBRAIN_PREFIX=0\nTENANT_CLASSES=gold:3,free:1\nRADIX_SESSIONS=7\n")
    names = ("BRAIN_BACKEND", "BRAIN_DEVICE", "BRAIN_BATCH", "BRAIN_PAGED", "RADIX_ENABLE",
             "BRAIN_PREFIX", "TENANT_CLASSES", "RADIX_SESSIONS")
    _fresh(monkeypatch, *names)
    monkeypatch.setattr(envcfg, "REPO_ROOT", tmp_path)
    built = []

    class Stop(Exception):
        pass

    def capture(app, **kw):
        built.append(app)
        raise Stop

    monkeypatch.setattr(brain, "make_server", capture)
    with pytest.raises(Stop):
        brain.main()
    parser = built[0].parser
    try:
        assert parser.batcher.tenancy is not None
        assert set(parser.batcher.tenancy.classes) == {"gold", "free", "default"}
        assert parser.transcripts.max_sessions == 7
    finally:
        parser.close()


def test_a_knob_only_in_the_dotenv_is_refused_at_voice_boot(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text("VOICE_STT=whisper-hf:x\n")
    _fresh(monkeypatch, "VOICE_STT")
    monkeypatch.setattr(envcfg, "REPO_ROOT", tmp_path)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 8"):
        voice.main()
