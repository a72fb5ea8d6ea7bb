"""Input formats beside xyz: Gaussian .gjf, MDL .mol, Tripos .mol2 and
GAMESS/ORCA/Q-Chem .inp (geometry sections only).

Counterpart of `multioptpy_tpu/io/formats.py`. Each reader returns
(symbols, coords_ang (N,3), charge, multiplicity).
"""

import numpy as np


def read_gjf(path):
    """Gaussian input: route section (#...), blank, title, blank,
    'charge mult', then atoms."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    # find the charge/multiplicity line: first line with exactly two ints
    # after at least one blank-line separator
    idx = None
    for i, ln in enumerate(lines):
        parts = ln.split()
        if len(parts) == 2:
            try:
                int(parts[0]), int(parts[1])
                idx = i
                break
            except ValueError:
                continue
    if idx is None:
        raise ValueError(f"no charge/multiplicity line found in {path}")
    charge, mult = int(lines[idx].split()[0]), int(lines[idx].split()[1])
    symbols, coords = [], []
    for ln in lines[idx + 1:]:
        parts = ln.split()
        if len(parts) < 4:
            break
        symbols.append(parts[0])
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return symbols, np.asarray(coords, dtype=np.float64), charge, mult


def read_mol(path):
    """MDL molfile (V2000): counts line at row 4, atom block follows."""
    with open(path) as f:
        lines = f.readlines()
    counts = lines[3].split()
    n_atoms = int(counts[0])
    symbols, coords = [], []
    for ln in lines[4:4 + n_atoms]:
        parts = ln.split()
        coords.append([float(parts[0]), float(parts[1]), float(parts[2])])
        symbols.append(parts[3])
    return symbols, np.asarray(coords, dtype=np.float64), 0, 1


def read_mol2(path):
    """Tripos mol2: the @<TRIPOS>ATOM block."""
    with open(path) as f:
        lines = f.readlines()
    symbols, coords = [], []
    in_atoms = False
    for ln in lines:
        if ln.startswith("@<TRIPOS>ATOM"):
            in_atoms = True
            continue
        if in_atoms:
            if ln.startswith("@<TRIPOS>"):
                break
            parts = ln.split()
            if len(parts) < 6:
                continue
            coords.append([float(parts[2]), float(parts[3]),
                           float(parts[4])])
            # atom type like "C.3" -> element "C"
            symbols.append(parts[5].split(".")[0])
    return symbols, np.asarray(coords, dtype=np.float64), 0, 1


def read_inp(path):
    """GAMESS ($DATA), ORCA (* xyz q m) and Q-Chem ($molecule) inputs."""
    with open(path) as f:
        text = f.read()
    lower = text.lower()
    if "$data" in lower:
        return _parse_gamess(text)
    if "* xyz" in lower or "*xyz" in lower:
        return _parse_orca(text)
    if "$molecule" in lower:
        return _parse_qchem(text)
    raise ValueError(f"unrecognized input format: {path}")


def _parse_gamess(text):
    lines = text.splitlines()
    symbols, coords = [], []
    in_data = False
    skipped = 0
    for ln in lines:
        if ln.strip().lower().startswith("$data"):
            in_data = True
            continue
        if in_data:
            if ln.strip().lower().startswith("$end"):
                break
            if skipped < 2:  # title + symmetry lines
                skipped += 1
                continue
            parts = ln.split()
            if len(parts) >= 5:
                symbols.append(parts[0])
                coords.append([float(parts[2]), float(parts[3]),
                               float(parts[4])])
    return symbols, np.asarray(coords, dtype=np.float64), 0, 1


def _parse_orca(text):
    lines = text.splitlines()
    symbols, coords = [], []
    charge, mult = 0, 1
    in_block = False
    for ln in lines:
        s = ln.strip()
        if s.lower().startswith("* xyz") or s.lower().startswith("*xyz"):
            parts = s.replace("*", "").split()
            charge, mult = int(parts[1]), int(parts[2])
            in_block = True
            continue
        if in_block:
            if s.startswith("*"):
                break
            parts = s.split()
            if len(parts) >= 4:
                symbols.append(parts[0])
                coords.append([float(parts[1]), float(parts[2]),
                               float(parts[3])])
    return symbols, np.asarray(coords, dtype=np.float64), charge, mult


def _parse_qchem(text):
    lines = text.splitlines()
    symbols, coords = [], []
    charge, mult = 0, 1
    in_block = False
    first = True
    for ln in lines:
        s = ln.strip()
        if s.lower().startswith("$molecule"):
            in_block = True
            continue
        if in_block:
            if s.lower().startswith("$end"):
                break
            parts = s.split()
            if first and len(parts) == 2:
                charge, mult = int(parts[0]), int(parts[1])
                first = False
                continue
            if len(parts) >= 4:
                symbols.append(parts[0])
                coords.append([float(parts[1]), float(parts[2]),
                               float(parts[3])])
    return symbols, np.asarray(coords, dtype=np.float64), charge, mult


def read_any(path):
    """Dispatch on extension (xyz handled by io.xyz)."""
    low = path.lower()
    if low.endswith((".gjf", ".com")):
        return read_gjf(path)
    if low.endswith(".mol"):
        return read_mol(path)
    if low.endswith(".mol2"):
        return read_mol2(path)
    if low.endswith(".inp"):
        return read_inp(path)
    from multioptpy_tpu_torch.io.xyz import read_xyz
    symbols, coords = read_xyz(path)
    return symbols, coords, 0, 1
