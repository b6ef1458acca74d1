"""Serialize / import-export demo — the reference's Demo/Program/import
analog: matrix -> compressed blob -> metadata query -> round-trip, plus
O(1) pack/unpack move semantics.
Run: python -m graphblas_tpu_torch.examples.serialize_demo"""

import scipy.sparse as sps

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.ops import serialize as SER

CODECS = ("none", "zlib", "gbz")


def main(device=None, n: int = 2000, density: float = 0.005) -> dict:
    S = sps.random(n, n, density, format="csr", random_state=1)
    A = gt.Matrix.from_scipy(S, device=device)
    blobs = {}
    for codec in CODECS:
        blob = SER.serialize(A, compression=codec)
        meta = SER.serialized_get(blob)   # query without deserializing
        blobs[codec] = (len(blob), meta["nvals"], meta["format"])
    blob = SER.serialize(A, compression="gbz")
    B = SER.deserialize(blob, device=A.device)
    assert B.isequal(A)

    # O(1) move semantics (GxB pack/unpack)
    meta, arrays = SER.unpack(A)
    assert A.nvals == 0  # A surrendered its arrays
    C = SER.pack((n, n), meta["dtype"], meta["format"], meta["orient"],
                 device=B.device,
                 **{k: v for k, v in arrays.items() if v is not None})
    assert C.isequal(B)
    return {"blobs": blobs, "blob": blob, "roundtrip": True,
            "pack": True}


if __name__ == "__main__":
    from graphblas_tpu_torch.examples import cli_device
    dev = cli_device(__doc__)
    gt.init()
    r = main(dev)
    for codec, (size, nvals, fmt) in r["blobs"].items():
        print(f"{codec:5s}: {size:9d} bytes  nvals={nvals} fmt={fmt}")
    print("round-trip OK")
    print("pack/unpack OK")
