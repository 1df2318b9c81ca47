"""Serving daemon CLI — micro-batched HTTP segmentation from a port
artifact:

    python -m pdac_pathological_image_segmentation_tpu_torch.cli.serve \\
        --artifact model.pdacpt --port 8000 --device cuda

then

    curl -s -X POST --data-binary @tile.png -H 'Content-Type: image/png' \\
        http://127.0.0.1:8000/v1/segment -o mask.png -D -

The flags are the JAX package's ``cli/serve.py``'s, plus ``--device``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="pathology_project")
    parser.add_argument("--artifact", required=True,
                        help="artifact file from cli.export")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--buckets", default="1,8,32",
                        help="comma-separated batch buckets")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="micro-batching window")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="probability threshold for X-Tumor-Fraction")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the startup run of each bucket")
    parser.add_argument("--verbose", action="store_true",
                        help="log each request")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)

    from pdac_pathological_image_segmentation_tpu_torch.infer.export import (
        load_serving_artifact,
    )
    from pdac_pathological_image_segmentation_tpu_torch.infer.server import (
        SegmentationServer,
    )

    artifact = load_serving_artifact(args.artifact, device=args.device)
    buckets = tuple(int(b) for b in args.buckets.split(",") if b.strip())
    server = SegmentationServer(
        (args.host, args.port), artifact,
        buckets=buckets, max_wait_ms=args.max_wait_ms,
        threshold=args.threshold, verbose=args.verbose)
    server.start(warmup=not args.no_warmup)
    meta = artifact.meta
    dtype = "int8" if meta.get("int8") else meta.get("compute_dtype")
    print(f"serving {meta.get('model')}/{meta.get('backbone')} "
          f"(tile {artifact.tile}, {dtype}) on "
          f"{artifact.device} at http://{args.host}:{server.server_address[1]}"
          f" — buckets {list(buckets)}, window {args.max_wait_ms} ms",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
