"""Command-line interface.

Mirrors the reference CLI surface (``/root/reference/app/Main.hs:17-78``):
visibility-count cap, full-dataset switch, backend/debug selection, input
directory, output file, old-gridder toggle, debug dump flags (backends:
gpu | cpu; ``--precision double`` for complex128 parity runs).

Examples:
    python -m ska_sdp_tpu.cli --mode aw  -i data/ -n 5000 -o out.h5
    python -m ska_sdp_tpu.cli --mode w   -i data/ --all -dphases
    python -m ska_sdp_tpu.cli --make-data data/ --nant 16 --ntime 24
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ska_sdp_tpu", description="SKA-SDP gridding/imaging in JAX"
    )
    p.add_argument("-n", type=int, default=None, help="visibility count cap")
    p.add_argument("--all", action="store_true", help="use every visibility")
    p.add_argument("-i", "--input-dir", default="data", help="input directory")
    p.add_argument("-o", "--output", default=None, help="output .h5 (/img)")
    p.add_argument(
        "--mode",
        choices=["aw", "w", "idg", "wcache", "conv", "simple", "predict"],
        default="aw",
        help="pipeline (aw/w/wcache/conv/simple imaging; idg: "
             "image-domain w-projection, no wkern file needed; predict: "
             "model image -> vis)",
    )
    p.add_argument("--subgrid", type=int, default=64,
                   help="IDG subgrid size (--mode idg / --idg)")
    p.add_argument("--channels", type=int, default=None,
                   help="image N spectral channels, each at its own "
                        "frequency (modes w, idg, aw --idg); record "
                        "binning is amortized per channel group; writes "
                        "/img (channel mean) + /img_cube [nch, n, n]")
    p.add_argument("--fov-pad", type=float, default=None,
                   help="IDG full-FOV guarantee: grid FOV/f and crop "
                        "(e.g. 0.75 bounds full-image error at ~1e-3; "
                        "default: plain FOV, accurate inside ~75%% radius)")
    p.add_argument("--idg", action="store_true",
                   help="use the IDG realization for --mode predict "
                        "(continuous-w degridding) or --mode aw (IDG-AW: "
                        "image-domain A-screens on pair-chunked subgrids, "
                        "for baseline-track data) — no wkern file needed "
                        "either way")
    p.add_argument("--aterms", action="store_true",
                   help="--mode predict --idg: apply direction-dependent "
                        "antenna terms from akern.h5 (IDG-AW degridding)")
    p.add_argument(
        "--distributed", action="store_true",
        help="run the multi-chip sharded pipeline over all visible "
             "devices (modes w, idg, and idg --channels N).  Multi-host: "
             "start one process per host with SKA_SDP_TPU_COORDINATOR/"
             "_NPROCS/_PROC_ID set (jax.distributed) and the mesh spans "
             "every global device; single-host it spans the local chips "
             "(test with JAX_PLATFORMS=cpu XLA_FLAGS="
             "--xla_force_host_platform_device_count=8)",
    )
    p.add_argument(
        "--backend", choices=["gpu", "cpu"], default=None,
        help="device backend; 'cpu' forces the CPU platform, 'gpu' "
             "requires a GPU and errors out if JAX selected another "
             "platform; default: whatever JAX selects",
    )
    p.add_argument(
        "--precision", choices=["single", "double"], default="single",
        help="single=complex64 (production), double=complex128 (CPU "
             "parity)",
    )
    p.add_argument("--wstep", type=float, default=2000.0,
                   help="w-bin width for --mode wcache (ref default 2000)")
    p.add_argument("-old", "--old", action="store_true", help="old gridder path")
    p.add_argument(
        "-dphases", "--dump-phases", action="store_true",
        help="print per-phase wall-clock timings",
    )
    p.add_argument(
        "--dump-intermediates", metavar="FILE", default=None,
        help="write pipeline intermediates (uv-grid planes, wbins, image) "
             "to FILE (/debug tree) — the reference's GridTesting debug "
             "dumps, asserted-pipeline edition (--mode w)",
    )
    p.add_argument(
        "--device-phases", action="store_true",
        help="run the pipeline as separately-synchronized stages and "
             "print per-stage DEVICE times (preprocess/sort/kernel/FFT "
             "shares; modes w, idg, aw and aw --idg) — the reference's "
             "dump_phases analog; implies -dphases",
    )
    p.add_argument(
        "--trace-dir", default=None, help="write jax.profiler traces here"
    )
    p.add_argument(
        "--metrics", default=None,
        help="append structured JSON-lines metrics to this file",
    )
    p.add_argument(
        "--xla-dump", default=None, metavar="DIR",
        help="dump XLA compiler artifacts (HLO, asm) to DIR",
    )
    p.add_argument("--checkpoint", default=None,
                   help="resumable run: checkpoint .h5 path (--mode w)")
    p.add_argument("--slab", type=int, default=1 << 20,
                   help="visibilities per checkpoint slab (each slab is "
                        "one device dispatch and one checkpoint write)")
    p.add_argument("--out-of-core", action="store_true",
                   help="stream visibility slabs from disk with background "
                        "prefetch (requires --checkpoint; --mode w)")
    p.add_argument("--model", default=None,
                   help="model image .h5 (/img) for --mode predict")
    p.add_argument("--theta", type=float, default=0.008)
    p.add_argument("--lam", type=int, default=300000)
    # synthetic-data generation
    p.add_argument("--make-data", metavar="DIR", default=None)
    p.add_argument("--nant", type=int, default=16)
    p.add_argument("--ntime", type=int, default=24)
    p.add_argument("--nw", type=int, default=16)
    p.add_argument("--qpx", type=int, default=4)
    p.add_argument("--nchan", type=int, default=1,
                   help="--make-data: spectral channels to simulate")
    p.add_argument("--chan-bw", type=float, default=1.0e5,
                   help="--make-data: channel spacing in Hz")
    return p



def _print_start() -> None:
    """The start line names the platform, device kind and device count
    (e.g. ``gpu (NVIDIA H200) x1``), so a CPU run can never pass for an
    accelerator run."""
    import jax

    devs = jax.devices()
    print(time.strftime("%Y-%m-%d %H:%M:%S"), "start imaging on",
          f"{devs[0].platform} ({devs[0].device_kind}) x{len(devs)}",
          flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.xla_dump:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_dump_to={args.xla_dump}"
        )
    if args.backend == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    elif args.backend == "gpu":
        # effective, not a no-op: verify JAX really selected a GPU
        import jax

        if jax.default_backend() != "gpu":
            print(
                f"error: --backend gpu requested but JAX selected "
                f"{jax.default_backend()!r} (no GPU visible?)",
                file=sys.stderr,
            )
            return 1
    if args.precision == "double":
        import jax

        jax.config.update("jax_enable_x64", True)
    from .utils.cache import enable_compile_cache

    enable_compile_cache()

    from .config import GridParams, ImagingConfig
    from .utils.timing import PhaseTimer

    # None (not False) keeps the SKA_SDP_TPU_DUMP_PHASES env fallback alive
    timer = PhaseTimer(
        enabled=(args.dump_phases or args.device_phases) or None,
        trace_dir=args.trace_dir,
    )

    if args.make_data:
        from .io.synthetic import SyntheticConfig, generate_dataset

        cfg = SyntheticConfig(
            theta=args.theta, lam=args.lam, nant=args.nant,
            ntime=args.ntime, nw_planes=args.nw, qpx=args.qpx,
            nchan=args.nchan, chan_bw=args.chan_bw,
        )
        paths, obs = generate_dataset(args.make_data, cfg)
        print(f"wrote {paths} ({obs['n']} visibilities)")
        return 0

    from .utils.metrics import MetricsSink

    metrics = MetricsSink(args.metrics)
    metrics.emit("run/start", mode=args.mode, n=args.n, all=args.all)
    cfg = ImagingConfig(
        grid=GridParams(theta=args.theta, lam=args.lam),
        precision_name=args.precision,
        n_vis=None if args.all else args.n,
        use_old_path=args.old,
    )
    vis_path = os.path.join(args.input_dir, "vis.h5")
    wkern_path = os.path.join(args.input_dir, "wkern.h5")
    akern_path = os.path.join(args.input_dir, "akern.h5")

    from .models import dataset as ds

    if args.aterms and not (args.mode == "predict" and args.idg):
        print("error: --aterms requires --mode predict --idg",
              file=sys.stderr)
        return 1
    required = [vis_path]
    if args.mode == "w" or (args.mode == "aw" and not args.idg):
        required.append(wkern_path)
    if args.mode == "aw" or (args.mode == "predict" and args.aterms):
        required.append(akern_path)
    for f in required:
        if not os.path.exists(f):
            print(f"error: input file not found: {f}", file=sys.stderr)
            return 1

    try:
        if args.distributed:
            return _dispatch_distributed(args, cfg, timer, metrics,
                                         vis_path, wkern_path)
        _print_start()
        return _dispatch(args, cfg, timer, metrics,
                         vis_path, wkern_path, akern_path)
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _dispatch_distributed(args, cfg, timer, metrics, vis_path, wkern_path):
    """``--distributed``: the multi-chip sharded pipelines as a user
    capability.  Initializes ``jax.distributed`` from the
    SKA_SDP_TPU_COORDINATOR/_NPROCS/_PROC_ID env (no-op single-process),
    builds the ("host","vis")/( "vis",) mesh over every global device,
    and runs the psum-merged sharded step for the selected mode."""
    import numpy as np

    from .parallel import initialize, make_host_vis_mesh
    from .parallel.mesh import make_mesh

    initialize()   # before anything touches a device
    _print_start()
    import jax

    nproc = jax.process_count()
    mesh = make_host_vis_mesh() if nproc > 1 else make_mesh()
    print(f"distributed: {nproc} process(es), "
          f"{mesh.devices.size} device(s), mesh axes {mesh.axis_names}",
          flush=True)

    if args.mode == "idg" and args.channels is not None and args.channels > 1:
        from .models import spectral

        mx, _img, cube = spectral.idg_gridding_multi_sharded(
            vis_path, args.channels, n=cfg.n_vis,
            outfile=args.output if jax.process_index() == 0 else None,
            config=cfg, timer=timer, subgrid=args.subgrid, mesh=mesh,
        )
        print(f"imaged {cube.shape[0]} channels (sharded over "
              f"{mesh.devices.size} devices), continuum image max: {mx}")
        metrics.emit("run/done", image_max=mx, channels=int(cube.shape[0]),
                     phases=timer.times, counters=timer.counters)
        return 0

    if args.mode not in ("w", "idg"):
        print("error: --distributed supports --mode w, --mode idg and "
              "--mode idg --channels N", file=sys.stderr)
        return 1

    from .parallel.ingest import load_vis_sharded

    with timer.phase("ingest/vis-sharded"):
        uvw, vis, freq = load_vis_sharded(vis_path, mesh, n=cfg.n_vis)
    wkerns = wbins = None
    if args.mode == "w":
        from .models.dataset import get_wkernels

        with timer.phase("ingest/wkern"):
            wkerns, wbins = get_wkernels(wkern_path, cfg.grid.theta)
    from .parallel.sharded import sharded_image

    with timer.phase("compile+grid+fft"):
        img = sharded_image(mesh, args.mode, uvw, vis, freq,
                            theta=cfg.grid.theta, lam=cfg.grid.lam,
                            precision=cfg.precision, subgrid=args.subgrid,
                            wkerns=wkerns, wbins=wbins)
        jax.block_until_ready(img)
    mx = float(np.asarray(img).max())
    if args.output and jax.process_index() == 0:
        from .io import h5, schema

        with timer.phase("write/img"):
            h5.create_file(args.output)
            h5.write_dataset(args.output, schema.IMG_DATASET,
                             np.asarray(img, np.float64))
    print(f"image max: {mx}")
    metrics.emit("run/done", image_max=mx, phases=timer.times,
                 counters=timer.counters)
    return 0


def _dispatch_multichannel(args, cfg, timer, metrics, vis_path, wkern_path,
                           akern_path):
    """``--channels N``: spectral-cube imaging through the multi-channel
    drivers (``models/spectral.py``) — every channel at its own frequency,
    binning amortized per channel group."""
    from .models import spectral

    if args.mode == "idg":
        mx, _img, cube = spectral.idg_gridding_multi(
            vis_path, args.channels, n=cfg.n_vis, outfile=args.output,
            config=cfg, timer=timer, subgrid=args.subgrid,
            fov_pad=args.fov_pad,
        )
    elif args.mode == "aw" and args.idg:
        mx, _img, cube = spectral.aw_idg_gridding_multi(
            akern_path, vis_path, args.channels, n=cfg.n_vis,
            outfile=args.output, config=cfg, timer=timer,
            subgrid=args.subgrid, fov_pad=args.fov_pad,
        )
    elif args.mode == "w":
        mx, _img, cube = spectral.w_gridding_multi(
            wkern_path, vis_path, args.channels, n=cfg.n_vis,
            outfile=args.output, config=cfg, timer=timer,
        )
    else:
        print("error: --channels supports --mode w, --mode idg and "
              "--mode aw --idg", file=sys.stderr)
        return 1
    print(f"imaged {cube.shape[0]} channels, continuum image max: {mx}")
    metrics.emit("run/done", image_max=mx, channels=int(cube.shape[0]),
                 phases=timer.times, counters=timer.counters)
    return 0


def _dispatch(args, cfg, timer, metrics, vis_path, wkern_path, akern_path):
    from .models import dataset as ds

    if args.channels is not None and args.channels > 1:
        return _dispatch_multichannel(args, cfg, timer, metrics, vis_path,
                                      wkern_path, akern_path)

    if args.mode == "predict":
        if not args.model:
            print("error: --mode predict requires --model", file=sys.stderr)
            return 1
        if args.idg and args.aterms:
            pred, peak = ds.aw_predict(
                akern_path, vis_path, args.model, n=cfg.n_vis,
                outfile=args.output, config=cfg, timer=timer,
                subgrid=args.subgrid, fov_pad=args.fov_pad,
            )
        elif args.idg:
            pred, peak = ds.idg_predict(
                vis_path, args.model, n=cfg.n_vis, outfile=args.output,
                config=cfg, timer=timer, subgrid=args.subgrid,
                fov_pad=args.fov_pad,
            )
        else:
            pred, peak = ds.w_predict(
                wkern_path, vis_path, args.model, n=cfg.n_vis,
                outfile=args.output, config=cfg, timer=timer,
            )
        print(f"predicted {pred.shape[0]} visibilities, peak |vis|: {peak}")
        metrics.emit("run/done", peak_vis=peak, phases=timer.times,
                     counters=timer.counters)
        return 0

    if args.mode == "idg":
        mx, _ = ds.idg_gridding(
            vis_path, n=cfg.n_vis, outfile=args.output, config=cfg,
            timer=timer, subgrid=args.subgrid, fov_pad=args.fov_pad,
            device_phases=args.device_phases,
        )
        print(f"image max: {mx}")
        metrics.emit("run/done", image_max=mx, phases=timer.times,
                     counters=timer.counters)
        return 0

    if args.mode == "aw":
        mx, _ = ds.aw_gridding(
            wkern_path, akern_path, vis_path, n=cfg.n_vis,
            outfile=args.output, old=args.old, config=cfg, timer=timer,
            idg=args.idg, fov_pad=args.fov_pad if args.idg else None,
            subgrid=args.subgrid if args.idg else 64,
            device_phases=args.device_phases,
        )
    elif args.mode == "w":
        if args.checkpoint and (args.device_phases or args.dump_intermediates):
            print("warning: --device-phases/--dump-intermediates are not "
                  "supported on the checkpointed/out-of-core paths (ignored)",
                  file=sys.stderr)
        if args.out_of_core and not args.checkpoint:
            print("error: --out-of-core requires --checkpoint",
                  file=sys.stderr)
            return 1
        if args.checkpoint and args.out_of_core:
            mx, _ = ds.w_gridding_out_of_core(
                wkern_path, vis_path, args.checkpoint, n=cfg.n_vis,
                outfile=args.output, slab=args.slab, config=cfg, timer=timer,
            )
        elif args.checkpoint:
            mx, _ = ds.w_gridding_checkpointed(
                wkern_path, vis_path, args.checkpoint, n=cfg.n_vis,
                outfile=args.output, slab=args.slab, config=cfg, timer=timer,
            )
        else:
            mx, _ = ds.w_gridding(
                wkern_path, vis_path, n=cfg.n_vis, outfile=args.output,
                config=cfg, timer=timer,
                device_phases=args.device_phases,
                dump_intermediates=args.dump_intermediates,
            )
    else:
        # simple / wcache / conv: the reference's test-only imaging drivers
        # (do_imaging + imgfn, /root/reference/src/Gridding.hs:509-549),
        # reachable from the CLI so every BASELINE.md config is one flag
        import jax.numpy as jnp
        import numpy as np

        from .config import KernelOptions
        from .models.imaging import (
            conv_imaging,
            do_imaging,
            simple_imaging,
            w_cache_imaging,
        )

        data = ds.load_vis_data(vis_path)
        n = cfg.n_vis or data.vis.shape[0]
        prec = cfg.precision
        from .ops import uvw_lambda

        uvw0 = uvw_lambda(data.frequency, jnp.asarray(data.uvw[:n], prec.real))
        if args.mode == "wcache":
            opts = KernelOptions(wstep=args.wstep)

            def imgfn(th, lam, uvw, src, vis):
                return w_cache_imaging(th, lam, uvw, src, vis, opts=opts)
        elif args.mode == "conv":
            # fixed oversampled kernel at the mean |w| (the reference's
            # conv tests pass a single w-kernel, GridTesting.hs:86-93)
            from .ops import w_kernel_bank

            w_mid = float(np.abs(np.asarray(uvw0[:, 2])).mean())
            opts = KernelOptions()
            kv = w_kernel_bank(
                cfg.grid.theta,
                jnp.asarray([w_mid], prec.real),
                opts,
                dtype=prec.real,
            )[0]

            def imgfn(th, lam, uvw, src, vis):
                return conv_imaging(kv, th, lam, uvw, src, vis)
        else:
            imgfn = simple_imaging
        res = do_imaging(
            cfg.grid.theta,
            cfg.grid.lam,
            uvw0,
            jnp.asarray(data.antenna1[:n]),
            jnp.asarray(data.antenna2[:n]),
            jnp.asarray(data.time[:n], prec.real),
            data.frequency,
            jnp.asarray(data.vis[:n], prec.complex),
            imgfn,
        )
        mx = float(res.pmax)
        if args.output:
            from .io import h5, schema

            h5.create_file(args.output)
            h5.write_dataset(
                args.output, schema.IMG_DATASET, np.asarray(res.image)
            )
    print(f"image max: {mx}")
    metrics.emit("run/done", image_max=mx, phases=timer.times,
                 counters=timer.counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
