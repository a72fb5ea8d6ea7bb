"""xyz / multi-frame trajectory parsing and writing.

In-memory arrays replace the reference's per-iteration file round-trips
(ref: multioptpy/fileio.py:53 xyz2list, :254 traj2list, :553 make_traj_file).
Coordinates on disk are Angstrom (the xyz convention); the returned arrays
are Angstrom too — unit conversion to Bohr happens at the System boundary.
"""

import numpy as np

from multioptpy_tpu_torch.periodic import symbols_to_z, z_to_symbol


def _parse_frame(lines, start):
    natoms = int(lines[start].split()[0])
    comment = lines[start + 1].rstrip("\n") if start + 1 < len(lines) else ""
    body = lines[start + 2:start + 2 + natoms]
    if len(body) < natoms:
        raise ValueError(
            f"truncated xyz frame: header declares {natoms} atoms but only "
            f"{len(body)} coordinate lines follow")
    symbols, coords = [], []
    for ln in body:
        parts = ln.split()
        symbols.append(parts[0])
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return symbols, np.array(coords, dtype=np.float64), comment, start + 2 + natoms


def _parse_atom_lines(lines):
    symbols, coords = [], []
    for ln in lines:
        parts = ln.split()
        if len(parts) < 4:
            raise ValueError(f"not an atom line: {ln!r}")
        symbols.append(parts[0])
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not symbols:
        raise ValueError("no atom lines")
    return symbols, np.array(coords, dtype=np.float64)


def read_xyz(path):
    """Read first frame of an xyz file -> (symbols, coords_ang (N,3)).

    Also accepts the reference's internal headerless format (e.g.
    test/aldol_rxn/_0.xyz): a "charge multiplicity" first line followed
    directly by atom lines, with no count/comment header (ref:
    fileio.py:53 xyz2list consumes these via make_geometry_list)."""
    with open(path) as f:
        raw = f.readlines()
    stripped = [ln for ln in raw if ln.strip()]
    tok = stripped[0].split() if stripped else []
    if len(tok) >= 2:
        try:
            int(tok[0]), int(tok[1])
            return _parse_atom_lines(stripped[1:])
        except ValueError:
            pass
    symbols, coords, _, _ = _parse_frame(raw, 0)
    return symbols, coords


def read_trajectory(path):
    """Read all frames -> (symbols, coords_ang (F,N,3), comments list).

    ref: fileio.py:254 traj2list.
    """
    with open(path) as f:
        lines = [ln for ln in f.readlines() if ln.strip() != "" or True]
    frames, comments = [], []
    symbols = None
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        try:
            symbols_i, coords, comment, i = _parse_frame(lines, i)
        except (ValueError, IndexError):
            break
        if symbols is None:
            symbols = symbols_i
        frames.append(coords)
        comments.append(comment)
    return symbols, np.stack(frames), comments


def format_xyz(symbols, coords_ang, comment=""):
    coords_ang = np.asarray(coords_ang, dtype=np.float64)
    out = [f"{len(symbols)}", comment]
    for s, (x, y, z) in zip(symbols, coords_ang):
        if not isinstance(s, str):
            s = z_to_symbol(int(s))
        out.append(f"{s:<3s} {x:19.12f} {y:19.12f} {z:19.12f}")
    return "\n".join(out) + "\n"


def write_xyz(path, symbols, coords_ang, comment=""):
    with open(path, "w") as f:
        f.write(format_xyz(symbols, coords_ang, comment))


def write_trajectory(path, symbols, frames_ang, comments=None):
    """Write multi-frame xyz (ref: fileio.py:553 make_traj_file)."""
    with open(path, "w") as f:
        for i, frame in enumerate(frames_ang):
            c = comments[i] if comments is not None else f"frame {i}"
            f.write(format_xyz(symbols, frame, c))


def symbols_and_z(symbols):
    return symbols, symbols_to_z(symbols)
