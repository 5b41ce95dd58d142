"""CLI: server / import / export / inspect / check / backup / restore /
config / generate-config.

Mirror of the reference's cobra command tree (cmd/*.go, ctl/*.go) on
argparse: ``python -m pilosa_tpu_torch <command>``, with the flags and
the output of ``python -m pilosa_tpu``.  ``server`` runs the node on the
card (there is no device flag: with no card it raises) in the foreground
until SIGINT or SIGTERM; the other commands are HTTP clients of a node.
"""

from __future__ import annotations

import argparse
import csv
import sys

from . import __version__
from .config import Config


def _load_config(args) -> Config:
    cfg = Config()
    if getattr(args, "config", None):
        cfg.load_file(args.config)
    cfg.load_env()
    if getattr(args, "data_dir", None):
        cfg.data_dir = args.data_dir
    if getattr(args, "bind", None):
        cfg.bind = args.bind
    if getattr(args, "verbose", False):
        cfg.verbose = True
    return cfg


def cmd_server(args) -> int:
    """ctl/server.go: run a node on the card until interrupted."""
    from .server import Server

    cfg = _load_config(args)
    srv = Server(cfg).open()
    try:
        import signal
        import threading

        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        stop.wait()
    finally:
        srv.close()
    return 0


def cmd_import(args) -> int:
    """ctl/import.go: CSV rows of row,col[,timestamp] (or col,value with
    --field-type int) -> sorted bits -> bulk import RPC."""
    from .net import InternalClient

    client = InternalClient(args.host)
    client.ensure_index(args.index)
    if args.create_field_type:
        opts = {"type": args.create_field_type}
        if args.create_field_type == "int":
            opts["min"] = args.field_min
            opts["max"] = args.field_max
        client.ensure_field(args.index, args.field, opts)

    def parse_ts(text: str) -> int:
        """RFC3339 timestamp column -> epoch NANOS, the import wire unit
        (ctl/import.go parseRFC3339 -> UnixNano).  Accepts zone
        designators and fractional seconds via fromisoformat; naive
        stamps are taken as UTC."""
        import datetime as dt

        try:
            t = dt.datetime.fromisoformat(text.replace("Z", "+00:00"))
        except ValueError:
            raise SystemExit(f"bad timestamp: {text!r}")
        if t.tzinfo is None:
            t = t.replace(tzinfo=dt.timezone.utc)
        return int(t.timestamp() * 1e6) * 1000

    rows, cols, vals, stamps = [], [], [], []
    is_value = args.create_field_type == "int"
    for path in args.files:
        f = sys.stdin if path == "-" else open(path)
        try:
            for rec in csv.reader(f):
                if not rec:
                    continue
                if is_value:
                    cols.append(int(rec[0]))
                    vals.append(int(rec[1]))
                else:
                    rows.append(int(rec[0]))
                    cols.append(int(rec[1]))
                    stamps.append(
                        parse_ts(rec[2]) if len(rec) > 2 and rec[2] else 0
                    )
        finally:
            if path != "-":
                f.close()

    SHARD_WIDTH = 1 << 20
    by_shard = {}
    if is_value:
        for c, v in zip(cols, vals):
            by_shard.setdefault(c // SHARD_WIDTH, ([], []))[0].append(c)
            by_shard[c // SHARD_WIDTH][1].append(v)
        for shard, (cs, vs) in sorted(by_shard.items()):
            client.import_values(args.index, args.field, shard, cs, vs)
    else:
        for r, c, t in zip(rows, cols, stamps):
            b = by_shard.setdefault(c // SHARD_WIDTH, ([], [], []))
            b[0].append(r)
            b[1].append(c)
            b[2].append(t)
        for shard, (rs, cs, ts) in sorted(by_shard.items()):
            client.import_bits(
                args.index, args.field, shard, rs, cs,
                timestamps=ts if any(ts) else None,
            )
    print(f"imported {len(cols)} bits into {args.index}/{args.field}")
    return 0


def cmd_export(args) -> int:
    """ctl/export.go: CSV export of a field."""
    from .net import InternalClient

    client = InternalClient(args.host)
    shards = client.max_shards().get(args.index, 0)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for shard in range(shards + 1):
            data = client._get(
                f"/export?index={args.index}&field={args.field}&shard={shard}",
                raw=True,
            )
            out.write(data.decode())
    finally:
        if args.output != "-":
            out.close()
    return 0


def cmd_inspect(args) -> int:
    """ctl/inspect.go: dump a fragment data file."""
    from .roaring import codec

    with open(args.path, "rb") as f:
        data = f.read()
    dec = codec.deserialize(data)
    print(f"file: {args.path}")
    print(f"bytes: {len(data)}")
    print(f"bits: {dec.values.size}")
    print(f"ops applied: {dec.op_n}")
    SHARD_WIDTH = 1 << 20
    if dec.values.size:
        import numpy as np

        row_ids = np.unique(dec.values >> np.uint64(20))
        print(f"rows: {row_ids.size} (max {int(row_ids.max())})")
    return 0


def cmd_check(args) -> int:
    """ctl/check.go: consistency check over fragment data files —
    structural container/offset/op-log validation (codec.check_bytes)
    plus a decode pass, and .cache JSON validation."""
    import json as json_mod

    from .roaring import codec

    failed = 0
    for path in args.paths:
        if path.endswith(".snapshotting"):
            continue
        if path.endswith(".cache"):
            try:
                with open(path) as f:
                    doc = json_mod.load(f)
                pairs = doc.get("pairs", [])
                if not all(
                    isinstance(p, list) and len(p) == 2 for p in pairs
                ):
                    raise ValueError("malformed pairs")
                print(f"{path}: ok ({len(pairs)} cached rows)")
            except Exception as e:
                print(f"{path}: FAILED: {e}")
                failed += 1
            continue
        try:
            with open(path, "rb") as f:
                data = f.read()
            problems = codec.check_bytes(data)
            for p in problems:
                print(f"{path}: PROBLEM: {p}")
            dec = codec.deserialize(data)
            import numpy as np

            vals = dec.values
            if vals.size and not np.all(vals[:-1] <= vals[1:]):
                raise ValueError("positions out of order")
            if problems:
                failed += 1
            else:
                print(f"{path}: ok ({vals.size} bits, {dec.op_n} ops)")
        except Exception as e:
            print(f"{path}: FAILED: {e}")
            failed += 1
    return 1 if failed else 0


def cmd_backup(args) -> int:
    """Stream every fragment of an index to a tar archive (the
    fragment-level backup path, fragment.go WriteTo/ReadFrom :1823-1998
    + http/client.go RetrieveShardFromURI :708)."""
    import io
    import json as json_mod
    import tarfile

    from .net import InternalClient

    client = InternalClient(args.host)
    schema = client.schema()
    idx_info = next((i for i in schema if i["name"] == args.index), None)
    if idx_info is None:
        print(f"index not found: {args.index}")
        return 1
    shards = client.max_shards().get(args.index, 0)
    with tarfile.open(args.output, "w:gz") as tar:
        meta = json_mod.dumps(idx_info).encode()
        info = tarfile.TarInfo(name="schema.json")
        info.size = len(meta)
        tar.addfile(info, io.BytesIO(meta))
        n = 0
        for f in idx_info["fields"]:
            for shard in range(shards + 1):
                try:
                    data = client.retrieve_shard(args.index, f["name"], shard)
                except Exception:
                    continue
                name = f"fragments/{f['name']}/{shard}"
                info = tarfile.TarInfo(name=name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
                n += 1
    print(f"backed up {n} fragments of {args.index} to {args.output}")
    return 0


def cmd_restore(args) -> int:
    """Restore a backup archive into a (possibly fresh) index."""
    import json as json_mod
    import tarfile

    from .net import InternalClient

    client = InternalClient(args.host)
    with tarfile.open(args.input, "r:gz") as tar:
        idx_info = json_mod.loads(tar.extractfile("schema.json").read())
        index = args.index or idx_info["name"]
        client.ensure_index(index, idx_info.get("options", {}).get("keys", False))
        for f in idx_info["fields"]:
            client.ensure_field(index, f["name"], f["options"])
        n = 0
        for member in tar.getmembers():
            if not member.name.startswith("fragments/"):
                continue
            _, field, shard = member.name.split("/")
            data = tar.extractfile(member).read()
            client.send_fragment(index, field, int(shard), data)
            n += 1
    print(f"restored {n} fragments into {index}")
    return 0


def cmd_config(args) -> int:
    """ctl/config.go: print the effective configuration."""
    cfg = _load_config(args)
    print(cfg.to_toml())
    return 0


def cmd_generate_config(args) -> int:
    print(Config().to_toml())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pilosa-tpu", description="bitmap index on one NVIDIA card (pilosa_tpu_torch)"
    )
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("server", help="run a pilosa-tpu node")
    sp.add_argument("-c", "--config", help="TOML config path")
    sp.add_argument("-d", "--data-dir", help="data directory")
    sp.add_argument("-b", "--bind", help="host:port to listen on")
    sp.add_argument("--verbose", action="store_true")
    sp.set_defaults(fn=cmd_server)

    ip = sub.add_parser("import", help="bulk import CSV bits")
    ip.add_argument("--host", default="http://localhost:10101")
    ip.add_argument("-i", "--index", required=True)
    ip.add_argument("-f", "--field", required=True)
    ip.add_argument("--create-field-type", dest="create_field_type", default="")
    ip.add_argument("--field-min", type=int, default=0)
    ip.add_argument("--field-max", type=int, default=0)
    ip.add_argument("files", nargs="+")
    ip.set_defaults(fn=cmd_import)

    ep = sub.add_parser("export", help="export a field to CSV")
    ep.add_argument("--host", default="http://localhost:10101")
    ep.add_argument("-i", "--index", required=True)
    ep.add_argument("-f", "--field", required=True)
    ep.add_argument("-o", "--output", default="-")
    ep.set_defaults(fn=cmd_export)

    np_ = sub.add_parser("inspect", help="inspect a fragment data file")
    np_.add_argument("path")
    np_.set_defaults(fn=cmd_inspect)

    cp = sub.add_parser("check", help="check fragment data files")
    cp.add_argument("paths", nargs="+")
    cp.set_defaults(fn=cmd_check)

    bp = sub.add_parser("backup", help="backup an index to a tar.gz")
    bp.add_argument("--host", default="http://localhost:10101")
    bp.add_argument("-i", "--index", required=True)
    bp.add_argument("-o", "--output", required=True)
    bp.set_defaults(fn=cmd_backup)

    rp = sub.add_parser("restore", help="restore an index from a tar.gz")
    rp.add_argument("--host", default="http://localhost:10101")
    rp.add_argument("-i", "--index", default="")
    rp.add_argument("input")
    rp.set_defaults(fn=cmd_restore)

    cf = sub.add_parser("config", help="print effective config")
    cf.add_argument("-c", "--config", help="TOML config path")
    cf.set_defaults(fn=cmd_config)

    gc = sub.add_parser("generate-config", help="print default config")
    gc.set_defaults(fn=cmd_generate_config)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
