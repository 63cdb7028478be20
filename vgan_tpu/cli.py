"""vgan-compatible command line interface.

Subcommand surface mirrors `src/vgan.cpp:31-191`:
  haplocart, euka, soibean, keelime, gam2prof, duprm, version
plus framework-native additions:
  build-db      compile GFA/.vg/.og/.gbz/.gg/.xg into the packed DB
  build-hc-db   self-host an hcfiles-layout DB from consensus FASTAs
  build-taxon-db  subset a per-taxon soibean DB from the super-graph
  vcf2fasta     single-sample VCF -> consensus FASTA
  map           standalone giraffe-equivalent mapper -> GAM
  plot-taxon / plot-detected / plot-trace / plot-k /
  plot-tree-posterior / tree-from-output   output visualization
  bench         print the one-line benchmark JSON
multi-host: --coordinator host:port --nproc N --procid I
soibean/euka resumable MCMC: --checkpoint PATH [--checkpoint-every N]

Flags are parsed with the reference's manual single-dash style
(`src/HaploCart.cpp:87-209`, `src/Euka.cpp:193-345`,
`src/soibean.cpp:260-402`).
"""
from __future__ import annotations

import sys
from typing import List

VERSION = "v3.0.0-jax0.1"


def _take(args: List[str], i: int) -> str:
    if i + 1 >= len(args):
        raise SystemExit(f"missing value for {args[i]}")
    return args[i + 1]


def _check_threads(val: str, prog: str) -> int:
    """Validate a `-t` value with the reference's contract
    (`src/HaploCart.cpp:184-191`, asserted by `src/test.cpp:766-789`):
    0 or < -1 raises, -1 means all hardware threads, a too-large count
    warns and clamps. The count itself only gates the native finalize
    threading here (device batching replaces OpenMP otherwise)."""
    import os

    n = int(val)
    if n < -1 or n == 0:
        raise RuntimeError(f"[{prog}] Error, invalid number of threads")
    avail = os.cpu_count() or 1
    if n == -1:
        return avail
    if n > avail:
        print(
            f"[{prog}] Warning, specified number of threads is greater "
            f"than the number available. Using {avail} threads",
            file=sys.stderr,
        )
        return avail
    return n


def _strip_multihost_flags(argv: List[str]) -> List[str]:
    """--coordinator host:port --nproc N --procid I (or VGAN_* env):
    join the cross-host runtime before dispatch (SURVEY §2.9 comm
    backend; see parallel/multihost.py)."""
    import os

    out: List[str] = []
    i = 0
    kw = {}
    while i < len(argv):
        if argv[i] == "--coordinator":
            kw["coordinator"] = _take(argv, i); i += 2
        elif argv[i] == "--nproc":
            kw["num_processes"] = int(_take(argv, i)); i += 2
        elif argv[i] == "--procid":
            kw["process_id"] = int(_take(argv, i)); i += 2
        else:
            out.append(argv[i]); i += 1
    if kw.get("coordinator") or os.environ.get("VGAN_COORDINATOR"):
        from .parallel import multihost

        multihost.init_distributed(**kw)
    return out


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    argv = _strip_multihost_flags(argv)
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(VERSION)
        return 0
    if cmd == "haplocart":
        return cmd_haplocart(rest)
    if cmd == "euka":
        return cmd_euka(rest)
    if cmd == "soibean":
        return cmd_soibean(rest)
    if cmd == "keelime":
        return cmd_keelime(rest)
    if cmd == "duprm":
        return cmd_duprm(rest)
    if cmd == "gam2prof":
        return cmd_gam2prof(rest)
    if cmd == "build-db":
        return cmd_build_db(rest)
    if cmd == "build-hc-db":
        return cmd_build_hc_db(rest)
    if cmd == "build-taxon-db":
        return cmd_build_taxon_db(rest)
    if cmd == "vcf2fasta":
        from .db.vcf2fasta import add_variants_to_fasta

        if len(rest) != 3:
            print("Usage: vgan vcf2fasta [vcf_file] [fasta_file] "
                  "[chromosome]")
            return 1
        return add_variants_to_fasta(rest[0], rest[1], rest[2])
    if cmd == "map":
        return cmd_map(rest)
    if cmd in ("plot-taxon", "plot-detected", "plot-trace", "plot-k",
               "plot-tree-posterior", "tree-from-output"):
        return cmd_plot(cmd, rest)
    if cmd == "bench":
        import runpy

        runpy.run_path("bench.py", run_name="__main__")
        return 0
    print(f"unknown subcommand {cmd}", file=sys.stderr)
    return 1


def cmd_haplocart(args: List[str]) -> int:
    from .pipelines.haplocart_runner import HaplocartConfig, run

    cfg = HaplocartConfig(db_dir="")
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-f":
            cfg.fasta = _take(args, i); i += 2
        elif a == "-fq1":
            cfg.fq1 = _take(args, i); i += 2
        elif a == "-fq2":
            cfg.fq2 = _take(args, i); i += 2
        elif a == "-g":
            cfg.gamfile = _take(args, i); i += 2
        elif a == "-i":
            cfg.interleaved = True; i += 1
        elif a == "-o":
            cfg.output = _take(args, i); i += 2
        elif a == "-e":
            cfg.background_error_prob = float(_take(args, i)); i += 2
        elif a == "-pf":
            cfg.posterior_file = _take(args, i); i += 2
        elif a == "-s":
            cfg.samplename = _take(args, i); i += 2
        elif a == "-q":
            cfg.quiet = True; i += 1
        elif a in ("--hc-files", "--hcfiles", "--db"):
            cfg.db_dir = _take(args, i); i += 2
        elif a == "-k":
            cfg.k = int(_take(args, i)); i += 2
        elif a == "--minw":
            cfg.w = int(_take(args, i)); i += 2
        elif a == "-w":
            # webapp HTML output; silences stderr like the reference
            # (`src/HaploCart.cpp:196-201` nulls cerr's rdbuf)
            cfg.webapp = True
            cfg.quiet = True
            i += 1
        elif a == "-t":
            _check_threads(_take(args, i), "HaploCart"); i += 2
        elif a == "--precise":
            # host f64 oracle scorer instead of the device batch path
            cfg.precise = True; i += 1
        elif a == "--profile":
            from .utils import profiling

            profiling.enable(); i += 1
        elif a == "--devices":
            # mesh size cap for the auto multi-chip sharding (default:
            # all local devices; 1 disables sharding)
            from .parallel.mesh import set_device_limit

            set_device_limit(int(_take(args, i))); i += 2
        else:
            print(f"[HaploCart] ignoring unknown flag {a}", file=sys.stderr)
            i += 1
    if not cfg.db_dir:
        raise SystemExit("[HaploCart] --db <dir> is required")
    run(cfg)
    from .utils.profiling import PROFILER

    PROFILER.report()
    return 0


def cmd_euka(args: List[str]) -> int:
    import numpy as np

    from .graph.packed import PackedGraph
    from .io import fastx, gam as gamio
    from .mapper.giraffe import BatchedMapper as Mapper
    from .models.damage import DamageModel
    from .pipelines import euka as ek
    from .pipelines.euka_runner import abundance_mcmc_from_result, write_outputs

    euka_dir = ""
    dbprefix = "euka_db"
    fq1 = fq2 = gamfile = ""
    interleaved = False
    out = "euka_output"
    n_iter, burnin = 10000, 100
    min_mq, min_frag, min_bins, max_bins = 29, 10, 6, 0
    entropy = 1.17
    deam5p = deam3p = ""
    run_mcmc_flag = True
    ltp = 5
    out_frag = False
    out_group = ""
    k, w = 20, 10
    safari = False
    checkpoint_path = None
    checkpoint_every = 100000
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--euka_dir":
            euka_dir = _take(args, i); i += 2
        elif a == "--checkpoint":
            # resumable abundance MCMC: snapshots to <path>.npz;
            # rerunning the same command continues from the snapshot
            checkpoint_path = _take(args, i); i += 2
        elif a == "--checkpoint-every":
            checkpoint_every = int(_take(args, i)); i += 2
        elif a == "--dbprefix":
            dbprefix = _take(args, i); i += 2
        elif a == "-fq1":
            fq1 = _take(args, i); i += 2
        elif a == "-fq2":
            fq2 = _take(args, i); i += 2
        elif a == "-g":
            gamfile = _take(args, i); i += 2
        elif a == "-i":
            interleaved = True; i += 1
        elif a == "-o":
            out = _take(args, i); i += 2
        elif a == "--iter":
            n_iter = int(_take(args, i)); i += 2
        elif a == "--burnin":
            burnin = int(_take(args, i)); i += 2
        elif a == "--minMQ":
            min_mq = int(_take(args, i)); i += 2
        elif a == "--minFrag":
            min_frag = int(_take(args, i)); i += 2
        elif a == "--minBins":
            min_bins = int(_take(args, i)); i += 2
        elif a == "--maxBins":
            max_bins = int(_take(args, i)); i += 2
        elif a == "--entropy":
            entropy = float(_take(args, i)); i += 2
        elif a == "--deam5p":
            deam5p = _take(args, i); i += 2
        elif a == "--deam3p":
            deam3p = _take(args, i); i += 2
        elif a == "--no-mcmc":
            run_mcmc_flag = False; i += 1
        elif a == "-l":
            ltp = int(_take(args, i)); i += 2
        elif a == "--outFrag":
            out_frag = True; i += 1
        elif a == "--outGroup":
            out_group = _take(args, i); i += 2
        elif a == "-k":
            k = int(_take(args, i)); i += 2
        elif a == "-w":
            w = int(_take(args, i)); i += 2
        elif a in ("-S", "--SAFARI"):
            # damage-aware RYmer seeding (functional here; the
            # reference parses the flag but never shipped the mapper,
            # `src/Euka.cpp:300-303`)
            safari = True; i += 1
        elif a == "-t":
            _check_threads(_take(args, i), "euka"); i += 2
        elif a == "--profile":
            from .utils import profiling

            profiling.enable(); i += 1
        elif a == "--devices":
            # mesh size cap for the auto multi-chip sharding (default:
            # all local devices; 1 disables sharding)
            from .parallel.mesh import set_device_limit

            set_device_limit(int(_take(args, i))); i += 2
        else:
            print(f"[euka] ignoring unknown flag {a}", file=sys.stderr)
            i += 1
    if fq1.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        raise SystemExit("[euka] Input file must be FASTQ, not FASTA")
    import os

    prefix = os.path.join(euka_dir, dbprefix)
    clades = ek.load_clade_info(prefix + ".clade")
    chunks = ek.load_clade_chunks(prefix + ".bins")
    graph = _load_graph(prefix)
    dm = DamageModel.from_profiles(deam5p or None, deam3p or None)
    from .utils.profiling import PROFILER

    from .parallel import multihost

    table = None
    stream_reads = None
    if gamfile:
        with PROFILER.stage("read_gam"):
            alignments = gamio.read_gam(gamfile)
        if multihost.active():
            # rank-sharded alignments; accumulators psum after scoring
            alignments = multihost.shard_reads(alignments)
    else:
        mapper = Mapper(graph, k=k, w=w, safari=safari)
        reads = fastx.read_fastq(fq1)
        r2 = fastx.read_fastq(fq2) if fq2 else []
        if multihost.active() and not (r2 or interleaved):
            reads = multihost.shard_reads(reads)
        from .mapper.batch_map import load_native

        with PROFILER.stage("map", items=len(reads) + len(r2)):
            if r2 and not interleaved and len(r2) == len(reads):
                alignments = mapper.map_read_pairs(reads, r2)
            elif interleaved and not r2 and len(reads) % 2 == 0:
                alignments = mapper.map_read_pairs(reads[0::2], reads[1::2])
            elif load_native() is not None:
                # columnar production path: no per-read objects; the
                # scorer streams over mapper chunks (r5) so scoring
                # overlaps mapping
                stream_reads = reads + r2
                alignments = []
            else:
                alignments = mapper.map_reads(reads + r2)
    scorer = ek.EukaScorer(graph, clades, chunks, damage=dm, length_to_prof=ltp)
    if not gamfile and stream_reads is not None:
        with PROFILER.stage("map+score", items=len(stream_reads)):
            res = scorer.score_table_stream(
                mapper.map_table_chunks(stream_reads),
                min_mq=min_mq, min_frag=min_frag, min_bins=min_bins,
                max_bins=max_bins, entropy_threshold=entropy,
            )
    else:
        if table is None and alignments:
            from .mapper.batch_map import load_native

            if load_native() is not None:
                from .mapper.batch_map import table_from_alignments

                table = table_from_alignments(alignments)
        with PROFILER.stage(
            "score",
            items=(table.n if table is not None else len(alignments)),
        ):
            if table is not None:
                res = scorer.score_table(
                    table, min_mq=min_mq, min_frag=min_frag,
                    min_bins=min_bins, max_bins=max_bins,
                    entropy_threshold=entropy,
                )
            else:
                res = scorer.score(
                    alignments, min_mq=min_mq, min_frag=min_frag,
                    min_bins=min_bins, max_bins=max_bins,
                    entropy_threshold=entropy,
                )
    if multihost.active():
        # global accumulators: counters/coverage/baseshift psum across
        # ranks, per-read lists concatenate, detection re-runs
        res = multihost.merge_euka_results(
            res, min_frag=min_frag, min_bins=min_bins, max_bins=max_bins,
            entropy_threshold=entropy,
        )
    if out_group:
        names = [c.name for c in clades]
        if out_group not in names:
            raise SystemExit("[euka] Outgroup not found in reference graph")
        gi = names.index(out_group)
        if gi not in res.detected:
            # outgroup is always reported (`src/Euka.cpp:560-582,619-663`)
            res.detected.append(gi)
    with PROFILER.stage("mcmc"):
        mcmc = (
            abundance_mcmc_from_result(
                res, n_iter=n_iter, burnin=burnin,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every,
            )
            if run_mcmc_flag
            else None
        )
    if not multihost.active() or multihost.is_host0():
        write_outputs(res, out, mcmc, length_to_prof=ltp, out_frag=out_frag)
    PROFILER.report()
    return 0


def cmd_soibean(args: List[str]) -> int:
    import os

    from .io import fastx, gam as gamio
    from .mapper.giraffe import BatchedMapper as Mapper
    from .pipelines import soibean as sb
    from .pipelines.soibean_runner import run_soibean_inference
    from .utils.newick import read_newick

    sbdir = ""
    dbprefix = ""
    treedir = ""
    fq1 = fq2 = gamfile = ""
    out = "soibean_output"
    n_iter, burnin, chains = 500000, 75000, 4
    spec_k = None
    penalty = 7
    k, w = 20, 10
    interleaved = False
    run_mcmc_flag = True
    alignment_detail = False
    path_thres = 0
    rand_start = False
    safari = False
    checkpoint_path = None
    checkpoint_every = 100000
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--dbprefix":
            dbprefix = _take(args, i); i += 2
        elif a in ("--sbdir", "--soibean_dir"):
            sbdir = _take(args, i); i += 2
        elif a == "--treedir":
            treedir = _take(args, i); i += 2
        elif a == "-fq1":
            fq1 = _take(args, i); i += 2
        elif a == "-fq2":
            fq2 = _take(args, i); i += 2
        elif a == "-g":
            gamfile = _take(args, i); i += 2
        elif a == "-o":
            out = _take(args, i); i += 2
        elif a == "--iter":
            n_iter = int(_take(args, i)); i += 2
        elif a == "--burnin":
            burnin = int(_take(args, i)); i += 2
        elif a == "--chains":
            chains = int(_take(args, i)); i += 2
        elif a == "-k":
            spec_k = int(_take(args, i)); i += 2
        elif a == "-P":
            penalty = int(_take(args, i)); i += 2
        elif a == "-t":
            _check_threads(_take(args, i), "soibean"); i += 2
        elif a == "-i":
            interleaved = True; i += 1
        elif a == "--randStart":
            rand_start = True; i += 1
        elif a == "--checkpoint":
            # resumable MCMC: snapshots to <path>.k<k>.c<chain>.npz;
            # rerunning the same command continues from the snapshot
            checkpoint_path = _take(args, i); i += 2
        elif a == "--checkpoint-every":
            checkpoint_every = int(_take(args, i)); i += 2
        elif a == "--no-mcmc":
            run_mcmc_flag = False; i += 1
        elif a == "--alignment-detail":
            alignment_detail = True; i += 1
        elif a == "--pathThres":
            path_thres = int(_take(args, i)); i += 2
        elif a in ("--deam5p", "--deam3p"):
            # accepted but inert even in the reference: the supported-
            # base damage marginal telescopes to log(0.9999999)
            # regardless of the profile (`src/getLCAfromGAM.h:340-353`
            # sums the full post-damage distribution in both branches)
            _take(args, i); i += 2
        elif a == "-z":
            _take(args, i); i += 2  # tmpdir, unused here
        elif a == "-M":
            _take(args, i); i += 2  # alternative minimizer index file
        elif a in ("-S", "--SAFARI"):
            # damage-aware RYmer seeding (functional here; inert in
            # the reference, `src/soibean.cpp:395-399`)
            safari = True; i += 1
        elif a == "--profile":
            from .utils import profiling

            profiling.enable(); i += 1
        elif a == "--devices":
            # mesh size cap for the auto multi-chip sharding (default:
            # all local devices; 1 disables sharding)
            from .parallel.mesh import set_device_limit

            set_device_limit(int(_take(args, i))); i += 2
        else:
            print(f"[soibean] ignoring unknown flag {a}", file=sys.stderr)
            i += 1
    prefix = os.path.join(sbdir, dbprefix)
    graph = _load_graph(prefix)
    from .utils.profiling import PROFILER

    # columnar path end-to-end (map_reads_table / native GAM decode ->
    # analyse_table, zero per-read objects) unless --alignment-detail
    # needs the row-at-a-time TSV writer or the native lib is absent
    from .mapper.batch_map import (
        load_native, table_from_alignments, table_from_gam,
    )

    table = alignments = None
    columnar = load_native() is not None and not alignment_detail
    if gamfile:
        with PROFILER.stage("read_gam"):
            if columnar:
                table = table_from_gam(gamfile)
            if table is None:
                alignments = gamio.read_gam(gamfile)
        n_in = table.n if table is not None else len(alignments)
    else:
        mapper = Mapper(graph, k=k, w=w, safari=safari)
        reads = fastx.read_fastq(fq1)
        with PROFILER.stage("map", items=len(reads)):
            if fq2 and not interleaved:
                r2 = fastx.read_fastq(fq2)
                if len(r2) == len(reads):
                    alignments = mapper.map_read_pairs(reads, r2)
                else:
                    alignments = mapper.map_reads(reads + r2)
            elif interleaved and len(reads) % 2 == 0:
                alignments = mapper.map_read_pairs(reads[0::2], reads[1::2])
            elif columnar:
                table = mapper.map_reads_table(reads)
            else:
                alignments = mapper.map_reads(reads)
        n_in = table.n if table is not None else len(alignments)
    with PROFILER.stage("analyse", items=n_in):
        if table is not None:
            stats = sb.analyse_table(graph, table, penalty=penalty)
        elif columnar:
            stats = sb.analyse_table(
                graph, table_from_alignments(alignments), penalty=penalty
            )
        else:
            stats = sb.analyse_reads(
                graph, alignments, penalty=penalty,
                detail_path=out if alignment_detail else "",
                path_thres=path_thres,
            )
    if not run_mcmc_flag:
        PROFILER.report()
        return 0
    tree = read_newick(
        os.path.join(treedir or os.path.join(sbdir, "tree_dir"),
                     dbprefix + ".new.dnd")
    )
    freqs = sb.load_base_freqs(
        os.path.join(sbdir, "soibean_db.baseFreq"), dbprefix
    )
    with PROFILER.stage("tree_mcmc"):
        run_soibean_inference(
            tree, stats, graph.path_names, freqs, out,
            n_iter=n_iter, burnin=burnin, chains=chains, specified_k=spec_k,
            rand_start=rand_start,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
        )
    PROFILER.report()
    return 0


def cmd_keelime(args: List[str]) -> int:
    from .pipelines.keelime import main_keelime

    return main_keelime(args)


def cmd_duprm(args: List[str]) -> int:
    """`vgan duprm sorted.gam > out.gam` (`src/rmdup.cpp`)."""
    from .io import gam as gamio
    from .pipelines.haplocart import remove_duplicates

    if not args:
        raise SystemExit("usage: vgan duprm sorted.gam [out.gam]")
    alignments = gamio.read_gam(args[0])
    kept = remove_duplicates(alignments)
    outpath = args[1] if len(args) > 1 else "/dev/stdout"
    gamio.write_gam(outpath, kept)
    print(
        f"removed {len(alignments) - len(kept)} duplicates, kept {len(kept)}",
        file=sys.stderr,
    )
    return 0


def cmd_gam2prof(args: List[str]) -> int:
    """Replay a GAM against euka bins, emit deamination profiles
    (`src/gam2prof.cpp:29-228`)."""
    import os

    import numpy as np

    from .graph.reconstruct import reconstruct_graph_sequence
    from .io import gam as gamio
    from .pipelines import euka as ek
    from .pipelines.euka_runner import _prof_rates, _write_prof

    euka_dir = ""
    dbprefix = "euka_db"
    gamfile = ""
    out = "gam2prof"
    ltp = 5
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--euka_dir":
            euka_dir = _take(args, i); i += 2
        elif a == "--dbprefix":
            dbprefix = _take(args, i); i += 2
        elif a == "-g":
            gamfile = _take(args, i); i += 2
        elif a == "-o":
            out = _take(args, i); i += 2
        elif a == "-l":
            ltp = int(_take(args, i)); i += 2
        else:
            i += 1
    prefix = os.path.join(euka_dir, dbprefix)
    clades = ek.load_clade_info(prefix + ".clade")
    chunks = ek.load_clade_chunks(prefix + ".bins")
    graph = _load_graph(prefix)
    baseshift = np.zeros((len(clades), 2 * ltp, 16), dtype=np.int64)
    counts = np.zeros(len(clades), dtype=np.int64)
    for a in gamio.iter_gam(gamfile):
        if a.identity == 0 or not a.path.mappings:
            continue
        g, r, _ = reconstruct_graph_sequence(graph, a.path, a.sequence)
        c_n, _e = ek.assign_clade(chunks, a.path.mappings[0].position.node_id)
        ek.baseshift_update(baseshift[c_n], g, r, ltp)
        counts[c_n] += 1
    for i_c, clade in enumerate(clades):
        if counts[i_c] == 0:
            continue
        _write_prof(
            f"{out}_{clade.name}.prof", _prof_rates(baseshift[i_c], ltp), ltp
        )
        # raw 16-cell counts (`Baseshift::display_counts`,
        # `src/baseshift.cpp:124-143`)
        with open(f"{out}_{clade.name}.all", "w") as f:
            hdr = (
                "A>A\tA>C\tA>G\tA>T\tC>A\tC>C\tC>G\tC>T\tG>A\tG>C\t"
                "G>G\tG>T\tT>A\tT>C\tT>G\tT>T\tPosition\n"
            )
            f.write(hdr)
            for p_ in range(2 * ltp):
                pos = p_ if p_ < ltp else -(2 * ltp) + p_
                f.write(
                    "\t".join(str(x) for x in baseshift[i_c][p_])
                    + f"\t\t{pos}\n"
                )
    return 0


def cmd_plot(cmd: str, args: List[str]) -> int:
    """Output visualization (share/vgan/plottingScripts equivalents;
    viz/plots.py):
      plot-taxon <prefix> <taxon>    plot_taxon.R
      plot-detected <prefix>         visualize_detected_taxa.sh
      plot-trace <file> [burnin]     soibeanPlotTrace.R
      plot-k <prefix>                soibeanPlotk.R
      plot-tree-posterior <trace.mcmc> <tree.dnd>  soibeanPlots.R
      tree-from-output <abundance.tsv>  make_tree_from_output.py
    """
    from .viz import plots

    try:
        if cmd == "plot-taxon":
            if len(args) < 2:
                raise SystemExit("usage: vgan plot-taxon prefix taxon")
            out = plots.plot_taxon(args[0], args[1])
        elif cmd == "plot-detected":
            if len(args) < 1:
                raise SystemExit("usage: vgan plot-detected prefix")
            out = ", ".join(plots.visualize_detected(args[0]))
        elif cmd == "plot-trace":
            if len(args) < 1:
                raise SystemExit(
                    "usage: vgan plot-trace trace.mcmc [burnin]"
                )
            out = plots.plot_trace(
                args[0], int(args[1]) if len(args) > 1 else 0
            )
        elif cmd == "plot-k":
            if len(args) < 1:
                raise SystemExit("usage: vgan plot-k prefix")
            out = plots.plot_k(args[0])
        elif cmd == "plot-tree-posterior":
            if len(args) < 2:
                raise SystemExit(
                    "usage: vgan plot-tree-posterior trace.mcmc tree.dnd"
                )
            out = plots.plot_tree_posterior(args[0], args[1])
        else:
            if len(args) < 1:
                raise SystemExit(
                    "usage: vgan tree-from-output abundance.tsv"
                )
            plots.tree_from_output(args[0])
            return 0
    except ImportError:
        print("[plot] matplotlib unavailable", file=sys.stderr)
        return 1
    print(f"[plot] wrote {out}", file=sys.stderr)
    return 0


def cmd_map(args: List[str]) -> int:
    """map --db <dir|prefix> -fq1 reads.fq [-fq2 mates.fq] -o out.gam
    [-k K] [--minw W]: the standalone giraffe-equivalent mapper —
    produces a GAM consumable by this framework and by vg."""
    from .io import fastx, gam as gamio
    from .mapper.giraffe import BatchedMapper

    db = ""
    fq1 = fq2 = ""
    out = "/dev/stdout"
    k, w = 20, 10
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--db":
            db = _take(args, i); i += 2
        elif a == "-fq1":
            fq1 = _take(args, i); i += 2
        elif a == "-fq2":
            fq2 = _take(args, i); i += 2
        elif a == "-o":
            out = _take(args, i); i += 2
        elif a == "-k":
            k = int(_take(args, i)); i += 2
        elif a == "--minw":
            w = int(_take(args, i)); i += 2
        else:
            print(f"[map] ignoring unknown flag {a}", file=sys.stderr)
            i += 1
    graph = _load_graph(db)
    mapper = BatchedMapper(graph, k=k, w=w)
    reads = fastx.read_fastq(fq1)
    n_total = len(reads)
    if fq2:
        r2 = fastx.read_fastq(fq2)
        n_total += len(r2)
        if len(r2) == len(reads):
            alignments = mapper.map_read_pairs(reads, r2)
        else:
            alignments = mapper.map_reads(reads + r2)
            for a2 in alignments:
                a2.read_paired = True
    else:
        alignments = mapper.map_reads(reads)
    gamio.write_gam(out, alignments)
    mapped = sum(1 for a2 in alignments if a2.identity != 0)
    print(f"[map] mapped {mapped}/{n_total} reads -> {out}", file=sys.stderr)
    return 0


def cmd_build_db(args: List[str]) -> int:
    """build-db <in.gfa|in.vg|in.og|in.gbz|in.gg|in.xg> <out_dir>
    [--k K --w W]: compile a GFA, vg-protobuf, bdsg-ODGI, GBZ,
    .gg+.gbwt or sdsl .xg graph into the packed graph + (optionally)
    persist the minimizer index."""
    import os

    if len(args) < 2:
        raise SystemExit(
            "usage: vgan build-db in.gfa|in.vg|in.og|in.gbz|in.gg|in.xg"
            " out_dir"
        )
    gfa, out_dir = args[0], args[1]
    os.makedirs(out_dir, exist_ok=True)
    g = _load_one_graph(gfa)
    g.save(os.path.join(out_dir, "graph.npz"))
    print(
        f"packed {g.n_nodes} nodes / {g.n_paths} paths -> {out_dir}/graph.npz",
        file=sys.stderr,
    )
    return 0


def cmd_build_hc_db(args: List[str]) -> int:
    """build-hc-db <ref.fa> <haplotypes.fa> <out_dir> [--phylo tree.tsv]
    [--node-len N]: self-host a HaploCart-layout DB (graph +
    reference-format sidecars: graph_paths / path_supports /
    parsed_pangenome_mapping / mappability.tsv / parents.txt /
    children.txt) from vcf2fasta-style consensus FASTAs. The one-time
    generator role of `src/readVG.h:31-194` + the mixemt phylotree
    scripts."""
    from .db.hc_build import build_hc_db

    pos = [a for a in args if not a.startswith("--")]
    if len(pos) < 3:
        raise SystemExit(
            "usage: vgan build-hc-db ref.fa haps.fa out_dir"
            " [--phylo tree.tsv] [--node-len N]"
        )
    phylo = None
    node_len = 8
    i = 0
    while i < len(args):
        if args[i] == "--phylo":
            phylo = _take(args, i); i += 2
        elif args[i] == "--node-len":
            node_len = int(_take(args, i)); i += 2
        else:
            i += 1
    g = build_hc_db(pos[0], pos[1], pos[2], phylo_tsv=phylo,
                    node_len=node_len)
    print(
        f"built hcfiles-layout DB: {g.n_nodes} nodes / {g.n_paths} "
        f"haplotype paths -> {pos[2]}",
        file=sys.stderr,
    )
    return 0


def cmd_build_taxon_db(args: List[str]) -> int:
    """build-taxon-db <db_dir> <taxon> [out_dir]: subset the per-taxon
    soibean graph from the super-DB using the clade file's node range
    (the make_graph_files.sh equivalent,
    `share/vgan/soibean_dir/make_graph_files.sh`)."""
    from .db.taxa import build_taxon_db

    if len(args) < 2:
        raise SystemExit("usage: vgan build-taxon-db db_dir taxon [out_dir]")
    out = build_taxon_db(
        args[0], args[1], args[2] if len(args) > 2 else None
    )
    print(f"wrote {out}", file=sys.stderr)
    return 0


def _load_one_graph(path: str):
    from .graph.packed import PackedGraph

    if path.endswith(".npz"):
        return PackedGraph.load(path)
    if path.endswith(".vg"):
        from .io.vgformat import read_vg

        return read_vg(path)
    if path.endswith(".og"):
        from .io.odgi import read_og

        return read_og(path)
    if path.endswith(".gbz"):
        from .io.gbz import load_packed_graph

        return load_packed_graph(path)
    if path.endswith(".gg"):
        from .io.gbz import load_packed_graph_gg

        return load_packed_graph_gg(path)
    if path.endswith(".xg"):
        from .io.xg import load_packed_graph_xg

        return load_packed_graph_xg(path)
    return PackedGraph.from_gfa(path)


def _load_graph(prefix: str):
    """Resolve a graph for a DB prefix: <prefix>.{npz,gfa,vg}, the
    path itself, or a graph.{npz,gfa,vg} next to it."""
    import os

    from .graph.packed import PackedGraph  # noqa: F401

    exts = (".npz", ".gfa", ".vg", ".og", ".gbz", ".giraffe.gbz",
            ".gg", ".xg")
    if prefix.endswith(exts) and os.path.exists(prefix):
        return _load_one_graph(prefix)
    for ext in exts:
        if os.path.exists(prefix + ext):
            return _load_one_graph(prefix + ext)
    d = os.path.dirname(prefix)
    for name in ("graph.npz", "graph.gfa", "graph.vg", "graph.og",
                 "graph.giraffe.gbz", "graph.gg", "graph.xg"):
        cand = os.path.join(d, name)
        if os.path.exists(cand):
            return _load_one_graph(cand)
    raise FileNotFoundError(f"no graph found for prefix {prefix}")


if __name__ == "__main__":
    sys.exit(main())
