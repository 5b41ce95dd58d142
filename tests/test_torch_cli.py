"""The port's CLI (pilosa_tpu_torch.cli, ``python -m pilosa_tpu_torch``)
against a port Server: the cases of ``tests/test_server_cli.py``
(``import``, ``export``, ``inspect``, ``check``, ``backup``, ``restore``,
``config``, ``generate-config``), each output held against the JAX
package's CLI on the same input.  ``--version`` and ``generate-config``
run as ``python -m pilosa_tpu_torch``, and ``server`` refuses to start
with no card.

Bits, CSV lines and printed text are discrete: exact agreement."""

import os
import subprocess
import sys

import pytest

from pilosa_tpu.cli import main as jcli
from pilosa_tpu_torch.cli import main as tcli
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.net import InternalClient
from pilosa_tpu_torch.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def server(tmp_path):
    cfg = Config()
    cfg.data_dir = str(tmp_path / "data")
    cfg.bind = "localhost:0"
    srv = Server(cfg, device="cpu").open(port_override=0)
    yield srv
    srv.close()


def test_cli_import_export_inspect_check(tmp_path, server, capsys):
    host = f"http://localhost:{server.port}"
    csv_path = tmp_path / "bits.csv"
    csv_path.write_text("1,10\n1,11\n2,10\n3,1048580\n")
    rc = tcli(["import", "--host", host, "-i", "ci", "-f", "f",
               "--create-field-type", "set", str(csv_path)])
    assert rc == 0
    assert capsys.readouterr().out == "imported 4 bits into ci/f\n"
    client = InternalClient(host)
    out = client.query("ci", "Row(f=1)")
    assert out["results"][0]["columns"] == [10, 11]
    # An int field through --create-field-type int.
    vals = tmp_path / "vals.csv"
    vals.write_text("10,5\n11,-3\n")
    assert tcli(["import", "--host", host, "-i", "ci", "-f", "v", "--create-field-type",
                 "int", "--field-min", "-10", "--field-max", "10", str(vals)]) == 0
    assert client.query("ci", "Sum(field=v)")["results"][0] == {"value": 2, "count": 2}

    out_path = tmp_path / "out.csv"
    rc = tcli(["export", "--host", host, "-i", "ci", "-f", "f", "-o", str(out_path)])
    assert rc == 0
    assert sorted(out_path.read_text().strip().splitlines()) == [
        "1,10", "1,11", "2,10", "3,1048580",
    ]
    capsys.readouterr()

    # inspect + check against the on-disk fragment file, in both CLIs.
    frag_path = os.path.join(server.data_dir, "ci", "f", "views", "standard", "fragments", "0")
    assert os.path.exists(frag_path)
    cache_path = frag_path + ".cache"
    for args in (["inspect", frag_path], ["check", frag_path]):
        assert tcli(args) == 0
        got = capsys.readouterr().out
        assert jcli(args) == 0
        assert got == capsys.readouterr().out
    assert tcli(["inspect", frag_path]) == 0
    captured = capsys.readouterr()
    assert "bits: 3" in captured.out
    assert tcli(["check", frag_path]) == 0
    assert "ok" in capsys.readouterr().out
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00\x01garbage")
    assert tcli(["check", str(bad)]) == 1
    got = capsys.readouterr().out
    assert jcli(["check", str(bad)]) == 1
    assert got == capsys.readouterr().out and "FAILED" in got
    if os.path.exists(cache_path):
        assert tcli(["check", cache_path]) == 0


def test_cli_config_and_generate_config(tmp_path, capsys, monkeypatch):
    assert tcli(["generate-config"]) == 0
    out = capsys.readouterr().out
    assert "data-dir" in out and "[cluster]" in out
    assert jcli(["generate-config"]) == 0
    assert capsys.readouterr().out == out
    p = tmp_path / "cfg.toml"
    p.write_text('data-dir = "/x"\n[server]\nbackend = "threaded"\n')
    monkeypatch.setenv("PILOSA_TPU_MAX_INFLIGHT", "77")
    assert tcli(["config", "-c", str(p)]) == 0
    out = capsys.readouterr().out
    assert jcli(["config", "-c", str(p)]) == 0
    assert capsys.readouterr().out == out
    assert 'backend = "threaded"' in out and "max-inflight = 77" in out


def test_cli_backup_restore(tmp_path, server):
    host = f"http://localhost:{server.port}"
    client = InternalClient(host)
    client.create_index("bk")
    client.create_field("bk", "f")
    client.query("bk", "Set(1, f=10) Set(2, f=11) Set(1048577, f=10)")
    archive = tmp_path / "bk.tar.gz"
    assert tcli(["backup", "--host", host, "-i", "bk", "-o", str(archive)]) == 0
    assert archive.exists()
    # Restore into a fresh index name on the same server.
    assert tcli(["restore", "--host", host, "-i", "bk2", str(archive)]) == 0
    out = client.query("bk2", "Row(f=10)")
    assert out["results"][0]["columns"] == [1, 1048577]
    out = client.query("bk2", "Row(f=11)")
    assert out["results"][0]["columns"] == [2]
    # The reference CLI restores the same archive into the port's node.
    assert jcli(["restore", "--host", host, "-i", "bk3", str(archive)]) == 0
    assert client.query("bk3", "Count(Row(f=10))")["results"] == [2]


def _module(*args, timeout=120, **env_kw):
    env = dict(os.environ, PYTHONPATH=ROOT, **env_kw)
    return subprocess.run([sys.executable, "-m", "pilosa_tpu_torch", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_python_m_version_and_generate_config():
    from pilosa_tpu_torch import __version__

    res = _module("--version")
    assert res.returncode == 0 and res.stdout.strip() == __version__
    res = _module("generate-config")
    assert res.returncode == 0
    assert res.stdout == Config().to_toml() + "\n"


def test_python_m_server_needs_a_card(tmp_path):
    """``server`` has no device flag: with no card (none visible) it
    raises instead of serving from the CPU."""
    res = _module("server", "-d", str(tmp_path / "data"), "-b", "localhost:0",
                  CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
