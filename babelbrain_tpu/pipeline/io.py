"""File I/O honoring the reference's data contracts.

* NIfTI-1 volumes (.nii / .nii.gz) — minimal pure-NumPy reader/writer (the
  image lacks nibabel). Supports the dtypes and affine conventions the
  pipeline uses; affine taken from srow when sform_code > 0, else qform,
  else pixdim scaling.
* Nested-dict HDF5 — the BabelViscoFDTD ``H5pySimple`` contract
  (`ReadFromH5py/SaveToH5py`): groups are dicts, datasets are arrays or
  scalars (SURVEY.md section 2.9; `InformationForDrivingSystems.md`).
  ``h5py`` is imported only by the HDF5 functions, so the NIfTI half of
  this module works without it.
"""

from __future__ import annotations

import gzip
import struct
import threading

import numpy as np

# h5py's own global lock is NOT sufficient for the low-level direct-chunk
# calls the BLOSC writer uses: H5Dwrite_chunk is entered with the lock
# released, and two AsyncSaver threads writing different files corrupt
# HDF5's global metadata cache ("ring type mismatch occurred for cache
# entry" / "Unspecified error in H5Dwrite_chunk", reproducibly within a
# few concurrent saves). All HDF5 file sessions in this module therefore
# serialize on one lock; NIfTI saves stay fully parallel.
_H5_LOCK = threading.Lock()

_NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


class Nifti:
    """A volume + affine, mirroring the nibabel Nifti1Image surface we use."""

    def __init__(self, data: np.ndarray, affine: np.ndarray, descrip: bytes = b""):
        self.data = np.asarray(data)
        self.affine = np.asarray(affine, np.float64)
        self.descrip = descrip

    def get_fdata(self):
        return self.data.astype(np.float64)

    @property
    def shape(self):
        return self.data.shape

    def zooms(self):
        return np.linalg.norm(self.affine[:3, :3], axis=0)

    def to_filename(self, path: str):
        save_nifti(path, self.data, self.affine, self.descrip)


def _quaternion_to_rotation(b, c, d):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def load_nifti(path: str) -> Nifti:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape = dim[1 : 1 + ndim]
    (datatype,) = struct.unpack_from("<h", raw, 70)
    pixdim = struct.unpack_from("<8f", raw, 76)
    (vox_offset,) = struct.unpack_from("<f", raw, 108)
    (scl_slope,) = struct.unpack_from("<f", raw, 112)
    (scl_inter,) = struct.unpack_from("<f", raw, 116)
    descrip = raw[148:228].rstrip(b"\0")
    (qform_code,) = struct.unpack_from("<h", raw, 252)
    (sform_code,) = struct.unpack_from("<h", raw, 254)
    quat = struct.unpack_from("<6f", raw, 256)
    srow = np.array(struct.unpack_from("<12f", raw, 280)).reshape(3, 4)

    dt = _NIFTI_DTYPES.get(datatype)
    if dt is None:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np.dtype(dt).newbyteorder("<"), count=count, offset=int(vox_offset)
    ).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data * slope + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        R = _quaternion_to_rotation(*quat[:3])
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        zooms = np.array(pixdim[1:4])
        zooms[2] *= qfac
        affine[:3, :3] = R * zooms
        affine[:3, 3] = quat[3:6]
    else:
        affine[:3, :3] = np.diag(pixdim[1:4])
    return Nifti(np.asarray(data), affine, descrip)


def save_nifti(path: str, data: np.ndarray, affine: np.ndarray, descrip: bytes = b""):
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[data.dtype]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    zooms = np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * (7 - len(zooms))))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    d = descrip[:79] if descrip else b""
    hdr[148 : 148 + len(d)] = d
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 2)  # sform_code = aligned
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine)[:3, :].ravel())
    hdr[344:348] = b"n+1\0"

    payload = bytes(hdr) + data.tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# nested-dict HDF5 (H5pySimple contract)
# ---------------------------------------------------------------------------


_BLOSC_FILTER_ID = 32001


def _write_blosc_dataset(group, name, arr):
    """Create a dataset carrying HDF5 filter 32001 and write one
    pre-compressed BLOSC1/LZ4 chunk directly (the filter pipeline is
    bypassed via ``write_direct_chunk``, so no blosc plugin is needed to
    WRITE; stock c-blosc/hdf5plugin readers — the reference's driving
    systems, `InformationForDrivingSystems.md:12-16` — decode it)."""
    import h5py

    from ..native import blosc_compress

    arr = np.ascontiguousarray(arr)
    chunk = blosc_compress(arr.tobytes(), typesize=arr.dtype.itemsize)
    space = h5py.h5s.create_simple(arr.shape)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(arr.shape)
    # cd_values per the blosc HDF5 filter convention:
    # (filter rev, blosc version, typesize, chunk bytes, clevel, shuffle,
    #  compressor code 1 = LZ4)
    dcpl.set_filter(
        _BLOSC_FILTER_ID, h5py.h5z.FLAG_OPTIONAL,
        (2, 2, arr.dtype.itemsize, arr.nbytes, 5, 1, 1),
    )
    dset_id = h5py.h5d.create(
        group.id, name.encode(), h5py.h5t.py_create(arr.dtype, logical=True),
        space, dcpl,
    )
    dset_id.write_direct_chunk((0,) * arr.ndim, chunk, filter_mask=0)


def save_dict_h5(data: dict, path: str, compression="gzip"):
    """SaveToH5py equivalent: nested dicts -> groups, values -> datasets.

    ``compression='blosc'`` writes arrays with the reference's BLOSC1/LZ4
    filter (id 32001) for driving-system interop; 'gzip' (default) uses
    the stock HDF5 deflate filter."""
    import h5py

    def write(group, d):
        for k, v in d.items():
            if isinstance(v, dict):
                write(group.create_group(str(k)), v)
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], dict):
                g = group.create_group(str(k))
                g.attrs["__list_of_dicts__"] = len(v)
                for i, item in enumerate(v):
                    write(g.create_group(str(i)), item)
            elif isinstance(v, str):
                group.attrs[str(k)] = v
            elif np.isscalar(v):
                group.create_dataset(str(k), data=v)
            elif v is None:
                group.attrs[str(k)] = "__none__"
            else:
                arr = np.asarray(v)
                if compression == "blosc" and arr.size > 128:
                    _write_blosc_dataset(group, str(k), arr)
                    continue
                kw = {}
                if compression and compression != "blosc" and arr.size > 128:
                    kw = dict(compression=compression)
                group.create_dataset(str(k), data=arr, **kw)

    with _H5_LOCK, h5py.File(path, "w") as f:
        write(f, data)


def read_h5_dataset(dset) -> "np.ndarray":
    """Read an h5py dataset, decoding BLOSC (filter 32001) natively if no
    codec plugin is installed.

    The reference writes every HDF5 payload through ``H5pySimple`` with
    BLOSC (`InformationForDrivingSystems.md:12-16`), so DataForSim/thermal
    files *it* produced need this path for interop."""
    try:
        return dset[()]
    except OSError:
        if "32001" not in dict(getattr(dset, "_filters", {})):
            raise
        from ..native import blosc_decompress

        full = np.zeros(dset.shape, dset.dtype)
        cshape = dset.chunks or dset.shape
        for ci in range(dset.id.get_num_chunks()):
            info = dset.id.get_chunk_info(ci)
            _, raw = dset.id.read_direct_chunk(info.chunk_offset)
            arr = np.frombuffer(blosc_decompress(raw), dset.dtype).reshape(cshape)
            sl = tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(info.chunk_offset, cshape, dset.shape)
            )
            full[sl] = arr[tuple(slice(0, s.stop - s.start) for s in sl)]
        return full


def load_dict_h5(path: str) -> dict:
    """ReadFromH5py equivalent (handles BLOSC-compressed reference files)."""
    import h5py

    def read(group):
        if "__list_of_dicts__" in group.attrs:
            n = int(group.attrs["__list_of_dicts__"])
            return [read(group[str(i)]) for i in range(n)]
        out = {}
        for k, v in group.attrs.items():
            if k == "__list_of_dicts__":
                continue
            out[k] = None if v == "__none__" else v
        for k, v in group.items():
            if isinstance(v, h5py.Group):
                out[k] = read(v)
            else:
                val = read_h5_dataset(v)
                if isinstance(val, bytes):
                    val = val.decode()
                out[k] = val
        return out

    with _H5_LOCK, h5py.File(path, "r") as f:
        return read(f)


class AsyncSaver:
    """Background thread-pool file saves with per-file completion tracking.

    The reference's FileManager writes its large intermediates on a thread
    pool with per-file condition variables so the pipeline continues while
    NIfTI/h5 serialization and gzip run (`BabelBrain/FileManager.py:127-152`).
    Same contract here: ``save_nifti``/``save_dict_h5`` submit and return
    immediately; ``wait(path)`` blocks on one file, ``wait()`` on all and
    re-raises the first writer exception. Usable as a context manager
    (waits on exit).
    """

    def __init__(self, max_workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._futures = {}

    def save_nifti(self, path, data, affine, descrip: bytes = b""):
        self._futures[path] = self._pool.submit(
            save_nifti, path, data, affine, descrip
        )

    def save_dict_h5(self, data: dict, path: str, compression="gzip"):
        self._futures[path] = self._pool.submit(
            save_dict_h5, data, path, compression
        )

    def wait(self, path: str | None = None):
        if path is not None:
            fut = self._futures.pop(path, None)
            if fut is not None:
                fut.result()
            return
        futures, self._futures = self._futures, {}
        for fut in futures.values():
            fut.result()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.wait()
        self._pool.shutdown(wait=True)
        return False
