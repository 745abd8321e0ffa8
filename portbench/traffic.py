"""The general traffic generator: proteins drawn from a mix's parameters.

A traffic mix is a JSON file under ``portbench/traffic/`` that names its
driver and its parameters; everything here reads those parameters and a
seed, so a new mix is a new data file. Lengths follow a truncated lognormal
(a catalogue of predicted ORFs), sequences are uniform over the 20 amino
acids, and each protein with a structure hit comes with the coordinates a
re-alignment would give the engine: a 3.8 Å random-walk CA chain of the hit,
gathered through a gapped alignment, with the alignment's insertion flags.

Copied, vectorised, from the port's ``synthetic.aligned_protein`` (the
column walk with matches, insertions and deletions) and
``ops/cmap_align.project_alignment_coords`` (sentinel coordinates at
unmapped positions); the benchmark imports neither.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
_AA_BYTES = np.frombuffer(AMINO_ACIDS.encode("ascii"), dtype=np.uint8)
# The engine's input convention for a query residue with no matched target
# residue: x = 1e6 + 1e3·i, y = z = 0 (far from every chain and each other).
SENTINEL_BASE = 1.0e6
SENTINEL_SPACING = 1.0e3
STEP_ANGSTROM = 3.8


def lengths(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """``n`` protein lengths from ``spec["lengths"]``: a lognormal with
    ``median`` and ``sigma``, redrawn outside ``[min, max]``."""
    p = spec["lengths"]
    lo, hi = int(p["min"]), int(p["max"])
    out = np.empty(0, np.int64)
    while out.size < n:
        draw = rng.lognormal(np.log(float(p["median"])), float(p["sigma"]),
                             size=2 * (n - out.size) + 16)
        draw = np.rint(draw).astype(np.int64)
        out = np.concatenate([out, draw[(draw >= lo) & (draw <= hi)]])
    return out[:n]


def sequence(rng: np.random.Generator, n: int) -> str:
    return _AA_BYTES[rng.integers(0, 20, size=n)].tobytes().decode("ascii")


def chain(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3) float32 random-walk CA trace with 3.8 Å steps."""
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(STEP_ANGSTROM * steps, axis=0).astype(np.float32)


def aligned_protein(rng: np.random.Generator, n: int, indel_rate: float):
    """One query of length ``n`` aligned to a synthetic hit.

    Alignment columns are drawn one by one: a query residue against a target
    gap (an insertion) with probability ``indel_rate / 2``, a target
    residue against a query gap (a deletion) with the same, a match
    otherwise, until ``n`` query residues are consumed. Returns
    ``(sequence, coords (n, 3) float32, insertion (n,) bool)``: matched
    positions carry their target residue's coordinates, insertions the
    sentinel coordinates.
    """
    while True:
        r = rng.random(size=2 * n + 64)
        kind = np.where(r < indel_rate / 2, 1, np.where(r < indel_rate, 2, 0))
        consumes_q = kind != 2
        q_count = np.cumsum(consumes_q)
        if q_count[-1] >= n:
            break
    cols = int(np.searchsorted(q_count, n)) + 1
    kind = kind[:cols]
    t_len = max(int(np.count_nonzero(kind != 1)), 1)
    target = chain(rng, t_len)
    t_index = np.cumsum(kind != 1) - 1        # target residue of each column
    q_cols = kind != 2
    q_kind = kind[q_cols]                      # per query residue: 0 or 1
    insertion = q_kind == 1
    coords = np.empty((n, 3), np.float32)
    coords[~insertion] = target[t_index[q_cols][~insertion]]
    pos = np.nonzero(insertion)[0]
    coords[pos, 0] = SENTINEL_BASE + SENTINEL_SPACING * pos
    coords[pos, 1:] = 0.0
    return sequence(rng, n), coords, insertion


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (``stream``) of a run's ``--seed``."""
    return np.random.default_rng([int(seed) % 2 ** 63, int(stream)])


def protein_pool(seed: int, spec: dict) -> list:
    """The mix's pool of ``spec["pool"]`` aligned proteins:
    ``[(sequence, coords, insertion), ...]``.

    The lengths come from the mix's own ``length_seed``, so every run
    serves the same sizes; ``seed`` shuffles them and draws the sequences,
    the chains and the alignments.
    """
    ns = lengths(np.random.default_rng(int(spec["length_seed"])),
                 int(spec["pool"]), spec)
    rng = seed_rng(seed, 1)
    rate = float(spec.get("indel_rate", 0.08))
    return [aligned_protein(rng, int(n), rate) for n in rng.permutation(ns)]


def replay_order(seed: int, pool_size: int):
    """Pool indices in a fresh random order from ``seed``, pass after pass,
    without end."""
    rng = seed_rng(seed, 2)
    while True:
        yield from rng.permutation(pool_size).tolist()


# -- a structure database and predict-function's queries ----------------------

_THREE = {"A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
          "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
          "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
          "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL"}


def pdb_text(sequence: str, coords: np.ndarray) -> str:
    """A CA-trace PDB: one ATOM record a residue, chain A (the format of
    the port's ``data/structures.write_ca_pdb``)."""
    lines = [f"ATOM  {i + 1:>5d}  CA  {_THREE[aa]:>3s} A{i + 1:>4d}"
             f"    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C"
             for i, (aa, (x, y, z)) in enumerate(zip(sequence, coords))]
    return "\n".join(lines + ["END"]) + "\n"


def read_pdb(text: str):
    """(sequence, (n, 3) float32 CA coordinates) of :func:`pdb_text`'s
    format: what a reader of the file gets."""
    one = {v: k for k, v in _THREE.items()}
    seq, xyz = [], []
    for line in text.splitlines():
        if line.startswith("ATOM") and line[12:16].strip() == "CA":
            seq.append(one[line[17:20]])
            xyz.append((float(line[30:38]), float(line[38:46]),
                        float(line[46:54])))
    return "".join(seq), np.asarray(xyz, np.float32)


# The deployment's scale, which a configuration states and a mix does not:
# the structures in the database searched, and the queries in one call.
SCALE = ("db_structures", "queries_per_call")


def deployment(config: dict, mix: dict) -> dict:
    """The mix's parameters with the configuration's scale (``SCALE``)."""
    return {**mix, **{k: config[k] for k in SCALE if k in config}}


def structure_dir(root: Path, spec: dict, db: list) -> Path:
    """The directory of ``db``'s PDB files under
    ``<root>/portbench/cache/db/``, at a path fixed by the database's
    parameters, written on a checkout's first run (to a side directory,
    then renamed) and read by every later run."""
    key = json.dumps({k: spec[k] for k in ("db_seed", "db_structures",
                                           "lengths")}, sort_keys=True)
    home = (Path(root) / "portbench" / "cache" / "db"
            / hashlib.sha1(key.encode()).hexdigest()[:12])
    done = home / "structures"
    if not done.is_dir():
        part = home / "structures.part"
        shutil.rmtree(part, ignore_errors=True)
        part.mkdir(parents=True)
        for sid, seq, coords in db:
            (part / f"{sid}.pdb").write_text(pdb_text(seq, coords))
        part.rename(done)
    return done


def structure_db(spec: dict) -> list:
    """``[(id, sequence, coords)]`` of the structure database of
    ``spec`` (:func:`deployment`'s), from its own ``db_seed``: the same
    database for every run."""
    rng = np.random.default_rng(int(spec["db_seed"]))
    ns = lengths(rng, int(spec["db_structures"]), spec)
    return [(f"s{i}", sequence(rng, int(n)), chain(rng, int(n)))
            for i, n in enumerate(ns)]


def hit_query(rng: np.random.Generator, seq: str, substitution_rate: float,
              indels=(1, 2), indel_len=(1, 3)) -> str:
    """A near-copy of ``seq``: ``substitution_rate`` of its positions
    substituted, then one or two short insertions or deletions away from
    the ends (the port's ``synthetic.hit_query``)."""
    out = list(seq)
    n_sub = max(1, int(round(substitution_rate * len(out))))
    for pos in rng.choice(len(out), size=n_sub, replace=False):
        out[pos] = rng.choice([a for a in AMINO_ACIDS if a != out[pos]])
    for _ in range(int(rng.integers(indels[0], indels[1] + 1))):
        k = int(rng.integers(indel_len[0], indel_len[1] + 1))
        pos = int(rng.integers(5, len(out) - 5 - k))
        if rng.random() < 0.5:
            del out[pos:pos + k]
        else:
            out[pos:pos] = list(sequence(rng, k))
    return "".join(out)


def query_calls(seed: int, spec: dict, db: list):
    """predict-function's calls, without end: each a list of
    ``(id, sequence, source)`` (``source`` the database index a hit query
    was made from, None for a query without a hit).

    Every run serves the same sizes: call k's hit queries come from the
    k-th block of a fixed order of the database (the mix's ``length_seed``)
    and its other queries have fixed lengths; ``seed`` shuffles each call
    and draws the mutations and the sequences.
    """
    per_call = int(spec["queries_per_call"])
    n_hit = int(round(per_call * float(spec["hit_share"])))
    fixed = np.random.default_rng(int(spec["length_seed"]))
    order = fixed.permutation(len(db))
    rng = seed_rng(seed, 4)
    k = 0
    while True:
        sources = [int(order[(k * n_hit + j) % len(db)])
                   for j in range(n_hit)]
        other = lengths(fixed, per_call - n_hit, spec)
        calls = [(db[s][1], s) for s in sources]
        calls = [(hit_query(rng, s, float(spec["substitution_rate"])), i)
                 for s, i in calls]
        calls += [(sequence(rng, int(n)), None) for n in other]
        perm = rng.permutation(len(calls))
        yield [(f"c{k}q{j}", *calls[i]) for j, i in enumerate(perm)]
        k += 1


def warm_queries(spec: dict, db: list) -> list:
    """``(id, sequence, source)``: a hit query and one without a hit in
    each length bucket that ``db`` fills, to warm a served path."""
    rng = np.random.default_rng(0)
    out, lo = [], 0
    for b in (128, 256, 512, 1024, 2048):
        pick = [i for i, (_, s, _) in enumerate(db) if lo < len(s) <= b]
        if pick:
            seq = db[pick[0]][1]
            out.append((f"w{b}h", hit_query(
                rng, seq, float(spec["substitution_rate"])), pick[0]))
            out.append((f"w{b}n", sequence(rng, len(seq)), None))
        lo = b
    return out


def serve_schedule(seed: int, spec: dict, db: list, seconds: float) -> list:
    """Open-loop requests due in ``seconds``: ``[(due_s, request id,
    [(id, sequence, source), ...])]``.

    Arrivals are a Poisson process at ``spec["rate"]`` requests a second
    and request sizes geometric (``spec["request_size"]``: ``p`` and
    ``max``), both from the mix's ``arrival_seed``; which proteins have a
    hit, their sources and the lengths of the others come from the
    ``length_seed``. So every run sends the same sizes at the same times;
    ``seed`` shuffles the proteins among the requests and draws the
    mutations and the sequences.
    """
    arrivals = np.random.default_rng(int(spec["arrival_seed"]))
    due, t = [], 0.0
    while True:
        t += float(arrivals.exponential(1.0 / float(spec["rate"])))
        if t >= seconds:
            break
        due.append(t)
    size = spec["request_size"]
    sizes = np.minimum(arrivals.geometric(float(size["p"]), len(due)),
                       int(size["max"]))
    fixed = np.random.default_rng(int(spec["length_seed"]))
    order = fixed.permutation(len(db))
    n = int(sizes.sum())
    is_hit = fixed.random(n) < float(spec["hit_share"])
    other_len = lengths(fixed, n, spec)
    rng = seed_rng(seed, 6)
    proteins, k = [], 0
    for j in range(n):
        if is_hit[j]:
            src = int(order[k % len(db)])
            k += 1
            proteins.append((hit_query(rng, db[src][1],
                                       float(spec["substitution_rate"])),
                             src))
        else:
            proteins.append((sequence(rng, int(other_len[j])), None))
    proteins = [proteins[i] for i in rng.permutation(n)]
    out, at = [], 0
    for r, (d, s) in enumerate(zip(due, sizes.tolist())):
        out.append((d, f"r{r}", [(f"r{r}p{i}", *proteins[at + i])
                                 for i in range(s)]))
        at += s
    return out
