"""Files of named groups of arrays, opened by their suffix.

The host datasets read their pairs, keypoint labels and cached synthetic
samples from "a file of named groups of arrays": one top-level name a
sample, holding named arrays (``optical``, ``thermal``, ``keypoints``,
``image``, ...), and sometimes top-level arrays (``image_data``). The JAX
package keeps these in HDF5 and reads HDF5 only. The card's machine has no
h5py, so the port also reads the same layout from a numpy ``.npz``
archive whose entries are named ``<group>/<dataset>`` (the keys that
``selfsup.export.NumpySink`` writes, so the export's labels are read as
they stand) and whose top-level arrays have no ``/`` in their name.

The suffix decides, and there is no option: ``.hdf5`` / ``.h5`` open
through h5py (imported here, when a file is opened), exactly as before;
any other suffix opens as ``.npz``. Group names are listed in name order,
as h5py lists them.

An ``.npz`` is opened anew for every read, as the datasets open an HDF5
file with ``swmr=True`` for every read, so that loader threads share no
open file. Parsing a zip archive's directory costs milliseconds at the
3,000 entries of the full cycle's synthetic set, more than the read, so
the directory is parsed once per file version (device, inode, size and
mtime of the open file) and kept; every read opens the file and reads its
members at their offsets.
"""
import os
import threading
import zipfile

import numpy as np

HDF5_SUFFIXES = ('.hdf5', '.h5')

_index_lock = threading.Lock()
_indexes = {}


def is_hdf5(path):
    return str(path).lower().endswith(HDF5_SUFFIXES)


def open_group_file(path, swmr=False):
    """The file at ``path`` for reading, as a context manager: an
    ``h5py.File`` for ``.hdf5`` / ``.h5`` (``swmr`` as h5py takes it), else
    an :class:`NpzGroupFile`. Both give ``keys()``, ``in`` and
    ``f[name]`` -> a group (``keys()``, ``in``, ``g[dataset]`` -> array)
    or a top-level array."""
    if is_hdf5(path):
        import h5py
        return (h5py.File(path, 'r', swmr=True) if swmr
                else h5py.File(path, 'r'))
    return NpzGroupFile(path)


def _npz_index(path, fh):
    """({entry name without '.npy': (data offset or None, ZipInfo)},
    {group: [dataset names]}, {top-level array names}) of the archive open
    as ``fh``, parsed once per file version (the version of the open file,
    so a file replaced meanwhile is not mistaken for it)."""
    st = os.fstat(fh.fileno())
    version = (st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns)
    with _index_lock:
        hit = _indexes.get(path)
        if hit is not None and hit[0] == version:
            return hit[1]
    index = {}
    with zipfile.ZipFile(fh) as zf:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith('.npy') \
                else info.filename
            offset = None
            if info.compress_type == zipfile.ZIP_STORED:
                # the member's data follows its local header: 30 bytes,
                # then the name and the extra field of the local header
                fh.seek(info.header_offset)
                local = fh.read(30)
                offset = (info.header_offset + 30
                          + int.from_bytes(local[26:28], 'little')
                          + int.from_bytes(local[28:30], 'little'))
            index[name] = (offset, info)
    groups, arrays = {}, set()
    for name in index:
        group, sep, ds = name.rpartition('/')
        if sep:
            groups.setdefault(group, []).append(ds)
        else:
            arrays.add(name)
    parsed = (index, groups, arrays)
    with _index_lock:
        _indexes[path] = (version, parsed)
    return parsed


class NpzGroupFile:
    """An ``.npz`` archive seen as groups of arrays: entry ``<g>/<d>`` is
    array ``d`` of group ``g``, an entry without ``/`` a top-level
    array."""

    def __init__(self, path):
        self.path = path
        self._fh = open(path, 'rb')
        try:
            self._index, self._groups, self._arrays = _npz_index(path,
                                                                 self._fh)
        except BaseException:
            self._fh.close()
            raise

    def read(self, name):
        """The array of entry ``name``."""
        offset, info = self._index[name]
        if offset is None:          # a compressed member
            self._fh.seek(0)
            with zipfile.ZipFile(self._fh) as zf, zf.open(info) as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        self._fh.seek(offset)
        return np.lib.format.read_array(self._fh, allow_pickle=False)

    def keys(self):
        return sorted(set(self._groups) | self._arrays)

    def __contains__(self, name):
        return name in self._groups or name in self._arrays

    def __getitem__(self, name):
        if name in self._groups:
            return _NpzGroup(self, name, self._groups[name])
        if name in self._arrays:
            return self.read(name)
        raise KeyError(name)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_npz_groups(path, groups):
    """Write ``groups`` ({group: {dataset: array}}, or an iterable of
    (group, {dataset: array}) pairs, consumed one at a time) to ``path`` as
    an uncompressed ``.npz`` with entries ``<group>/<dataset>``, the file
    ``np.savez`` writes. The archive is written beside ``path`` and moved
    over it when complete, so a reader never sees half a file."""
    items = groups.items() if isinstance(groups, dict) else groups
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with zipfile.ZipFile(tmp, 'w', zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for group, arrays in items:
                for ds, value in arrays.items():
                    with zf.open(f"{group}/{ds}.npy", 'w',
                                 force_zip64=True) as f:
                        np.lib.format.write_array(f, np.asanyarray(value),
                                                  allow_pickle=False)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_groups(path, groups):
    """Write ``groups`` ({group: {dataset: array}} or (group, arrays)
    pairs) to ``path`` by its suffix: HDF5 through h5py (imported here)
    for ``.hdf5`` / ``.h5``, one h5py group a group and one dataset an
    array, else :func:`write_npz_groups`."""
    if not is_hdf5(path):
        return write_npz_groups(path, groups)
    import h5py
    items = groups.items() if isinstance(groups, dict) else groups
    with h5py.File(path, 'w') as f:
        for group, arrays in items:
            g = f.create_group(group)
            for ds, value in arrays.items():
                g.create_dataset(ds, data=value)


class _NpzGroup:
    def __init__(self, file, name, datasets):
        self._file, self._name, self._datasets = file, name, datasets

    def keys(self):
        return sorted(self._datasets)

    def __contains__(self, ds):
        return ds in self._datasets

    def __getitem__(self, ds):
        if ds not in self._datasets:
            raise KeyError(f"{self._name}/{ds}")
        return self._file.read(f"{self._name}/{ds}")
