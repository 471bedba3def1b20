"""Golden first contact of the PyTorch port with a real rrtmgp-data checkout
(counterpart of scripts/golden_contact.py).

The port's golden-flux matrix (tests/test_torch_real_data.py, the same 18
cases and tolerances as tests/test_real_data.py) activates only where an
rrtmgp-data v1.9 checkout is present. A wrong, partial or mis-versioned
checkout must fail as a checkout problem, never pass for a physics failure.
This script makes the first contact one command:

    RRTMGP_DATA=/path/to/rrtmgp-data python scripts/golden_contact_torch.py

Gates (each reported; a hard failure skips the later ones):
  1. CHECKOUT IDENTITY: the git tree sha1 of the checkout, computed as git
     does (blob and tree hashing, .git excluded), against the v1.9 pin of
     RRTMGP.jl's Artifacts.toml (git-tree-sha1
     d601aa60f46f03d12db9841833c7b25bd4dcd785; release tarball sha256
     e0f868c32efbbe6c0a5bd9b764718f74d9f53b476f65a0d806988bbc83dd13c1). A
     mismatch aborts (--allow-unpinned proceeds anyway, e.g. for a partial
     checkout or a newer data release).
  2. STRUCTURE: rrtmgp_tpu_torch.data.manifest.validate_rrtmgp_data (the
     variables, dimension names and size relations of the six lookup files,
     the v1.9 dimension pins unless --lenient) and the presence of the
     input and reference flux files (rrtmgp_tpu_torch.data.artifact_paths).
  3. GOLDEN MATRIX: tests/test_torch_real_data.py through pytest in each eta
     node mode asked for (reference first, the mode the Fortran goldens
     need; see tests/test_real_data.py), then a parity report of each
     case's L-inf errors. The reference mode decides the exit code. pytest
     runs with --noconftest: tests/conftest.py configures JAX, which a
     machine with only the port has not got. The solves run on the card
     when there is one, else on the CPU; the report names the device.

Exit status: 2 usage, 3 wrong checkout, 4 structure, 5 the reference-mode
matrix failed (or passed with no case line read), 0 identity (unless
--allow-unpinned), structure and the reference-mode matrix all passed.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# RRTMGP.jl Artifacts.toml, rrtmgp-data v1.9
PIN_TREE_SHA1 = "d601aa60f46f03d12db9841833c7b25bd4dcd785"
PIN_TARBALL_SHA256 = "e0f868c32efbbe6c0a5bd9b764718f74d9f53b476f65a0d806988bbc83dd13c1"


def _sha1(kind: bytes, data: bytes) -> bytes:
    h = hashlib.sha1()
    h.update(kind + b" %d\0" % len(data))
    h.update(data)
    return h.digest()


def git_tree_sha1(root: str) -> str:
    """Git tree sha1 of a directory, computed as git does (no git binary
    needed): blob = sha1("blob <n>\\0" + bytes); tree entries are "<mode>
    <name>\\0" + 20-byte sha1, sorted by name with directories compared as
    name + "/"; empty directories are not tracked. A clone at the tag or
    the extracted release tarball of rrtmgp-data v1.9 gives the pinned
    hash."""

    def hash_tree(d: str) -> bytes | None:
        entries = []
        for name in os.listdir(d):
            if name == ".git":
                continue
            p = os.path.join(d, name)
            if os.path.islink(p):
                entries.append((name, b"120000", _sha1(b"blob", os.readlink(p).encode()), False))
            elif os.path.isdir(p):
                sub = hash_tree(p)
                if sub is not None:
                    entries.append((name, b"40000", sub, True))
            elif os.path.isfile(p):
                with open(p, "rb") as f:
                    blob = _sha1(b"blob", f.read())
                entries.append((name, b"100755" if os.access(p, os.X_OK) else b"100644", blob, False))
        if not entries:
            return None
        entries.sort(key=lambda e: e[0] + ("/" if e[3] else ""))
        return _sha1(b"tree", b"".join(mode + b" " + name.encode() + b"\0" + sha for name, mode, sha, _ in entries))

    digest = hash_tree(root)
    return digest.hex() if digest else "<empty>"


def check_identity(data_dir: str) -> bool:
    print("== 1. checkout identity (git tree sha1 vs the v1.9 pin) ==")
    got = git_tree_sha1(data_dir)
    ok = got == PIN_TREE_SHA1
    print(f"   computed: {got}")
    print(f"   pinned:   {PIN_TREE_SHA1}  (rrtmgp-data v1.9, RRTMGP.jl Artifacts.toml)")
    if ok:
        print("   MATCH: byte-identical to the pinned v1.9 release tree")
    else:
        print("   MISMATCH: this is NOT a pristine rrtmgp-data v1.9 tree.")
        print("   (expected: git clone --branch v1.9 https://github.com/earth-system-radiation/rrtmgp-data,")
        print(f"    or the v1.9 release tarball, sha256 {PIN_TARBALL_SHA256})")
        print("   A golden failure against an unpinned checkout is a CHECKOUT problem until proven otherwise.")
    return ok


def check_structure(data_dir: str, strict_v19: bool = True) -> bool:
    print("\n== 2. structure validation (rrtmgp_tpu_torch/data/manifest.py) ==")
    sys.path.insert(0, REPO)
    from rrtmgp_tpu_torch.data import artifact_paths as ap
    from rrtmgp_tpu_torch.data.manifest import ManifestError, validate_rrtmgp_data

    try:
        issues = validate_rrtmgp_data(data_dir, strict_v19=strict_v19)
    except ManifestError as e:
        print(f"   FAIL {e}")
        return False
    for fname in sorted(issues):
        print(f"   {'FAIL' if issues[fname] else 'ok  '} {fname}")
        for m in issues[fname]:
            print(f"        - {m}")
    os.environ["RRTMGP_DATA"] = data_dir
    wanted = [ap.get_input_filename(kind, bs) for kind in ("clearsky", "allsky") for bs in ("lw", "sw")]
    wanted += [ap.get_reference_filename(*args) for args in (
        ("gas", "lw", "flux_up"), ("gas", "lw", "flux_dn"), ("gas", "sw", "flux_up"), ("gas", "sw", "flux_dn"),
        ("gas_clouds", "lw", None), ("gas_clouds", "sw", None),
        ("gas_clouds_aerosols", "lw", None), ("gas_clouds_aerosols", "sw", None))]
    missing = [p for p in wanted if not os.path.exists(p)]
    for p in missing:
        print(f"   FAIL missing input/reference file: {p}")
    ok = not any(issues.values()) and not missing
    print(f"   structure: {'OK' if ok else 'FAILED'}")
    return ok


#: one case line of tests/test_torch_real_data.py, "<case> L-inf: up U, dn D
#: W/m^2 (tol T, device DEV)", after the progress characters pytest -q
#: prints at the start of a line (the outcome of the test before)
LINF_RE = re.compile(
    r"^[.FEsx]*(?P<case>[a-z][\w()=,\- ]*?)\s+L-inf:\s+up\s+(?P<up>[\d.e+-]+),\s+dn\s+(?P<dn>[\d.e+-]+)(?:\s+W/m\^2)?"
    r"\s+\(tol\s+(?P<tol>[\d.e+-]+)(?:,\s+device\s+(?P<device>[^)]+))?\)",
    re.M,
)


def run_matrix(data_dir: str, eta_mode: str) -> tuple[bool, list[dict], str]:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["RRTMGP_DATA"] = data_dir
    env["RRTMGP_ETA_NODE_MODE"] = eta_mode
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_real_data.py", "-q", "--noconftest",
         "-p", "no:cacheprovider"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3600,
    )
    rows = [m.groupdict() for m in LINF_RE.finditer(r.stdout)]
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    return r.returncode == 0, rows, summary


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_dir", nargs="?", default=os.environ.get("RRTMGP_DATA"),
                   help="rrtmgp-data checkout (default: $RRTMGP_DATA)")
    p.add_argument("--allow-unpinned", action="store_true",
                   help="run the matrix even when the tree hash mismatches")
    p.add_argument("--skip-identity", action="store_true", help="skip the tree-hash computation entirely")
    p.add_argument("--lenient", action="store_true",
                   help="skip the strict v1.9 dimension pins (structure-only validation; for newer data "
                        "releases or rehearsals)")
    p.add_argument("--modes", default="reference,continuous",
                   help="comma-separated eta node modes to run (default: reference,continuous; 'reference' "
                        "decides the exit code)")
    args = p.parse_args()
    if not args.data_dir:
        print("usage: RRTMGP_DATA=/path/to/rrtmgp-data python scripts/golden_contact_torch.py", file=sys.stderr)
        return 2
    data_dir = os.path.abspath(args.data_dir)
    if not os.path.isdir(data_dir):
        print(f"not a directory: {data_dir}", file=sys.stderr)
        return 2
    print(f"rrtmgp_tpu_torch golden first contact\ndata: {data_dir}\n")

    identity_ok = True
    if args.skip_identity:
        print("== 1. checkout identity: SKIPPED (--skip-identity) ==")
    else:
        identity_ok = check_identity(data_dir)
        if not identity_ok and not args.allow_unpinned:
            print("\nABORT: wrong checkout (use --allow-unpinned to force).")
            return 3

    if not check_structure(data_dir, strict_v19=not args.lenient):
        print("\nABORT: structure validation failed; the loaders would misread these files.")
        return 4

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    print(f"\n== 3. golden matrix (18 tests x eta modes {modes}) ==")
    results = {}
    for mode in modes:
        ok, rows, summary = run_matrix(data_dir, mode)
        results[mode] = (ok, rows)
        print(f"   eta_node_mode={mode}: {summary or ('PASS' if ok else 'FAIL')}")

    print("\n## Parity report (L-inf W/m^2 vs Fortran reference fluxes)\n")
    print("| case | tol | device | reference-mode up/dn | continuous-mode up/dn |")
    print("|---|---|---|---|---|")
    ref_rows = {r["case"].strip(): r for r in results.get("reference", (False, []))[1]}
    cont_rows = {r["case"].strip(): r for r in results.get("continuous", (False, []))[1]}
    for case, rr in ref_rows.items():
        cc = cont_rows.get(case)
        ccs = f"{cc['up']} / {cc['dn']}" if cc else "-"
        print(f"| {case} | {rr['tol']} | {rr['device'] or '-'} | {rr['up']} / {rr['dn']} | {ccs} |")

    ref_ok = results.get("reference", (False, []))[0]
    if ref_ok and not ref_rows:
        print("\nGOLDEN PARITY UNKNOWN: the reference-mode matrix passed but no L-inf line was read")
        return 5
    if ref_ok and identity_ok:
        verdict = "GOLDEN PARITY ACHIEVED"
    elif ref_ok:
        verdict = "matrix green but checkout UNPINNED: re-verify with a pristine v1.9 tree"
    else:
        verdict = "GOLDEN PARITY FAILED (reference mode)"
    print(f"\n{verdict}")
    return 0 if ref_ok else 5


if __name__ == "__main__":
    sys.exit(main())
