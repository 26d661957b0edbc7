"""Share of the roofline that the ``attn_density`` kernels reach in the
traced window, %: the least time the card could take for every prompt
extend's launches (one a layer; operations and bytes from
``rooflines/attn_density.py``) over the device time of the launches that
give the density (the served form with its mass, ``..., true, true>``,
and its reduction kernel).  A restore's recompute runs the same kernel
without the mass and is not counted on either side."""


def read(run):
    ops = run.trace.by_name(
        r"attn_density_tc_kernel<\s*\d+,\s*\d+,\s*\d+,\s*true,\s*true\s*>"
        r"|attn_density_reduce_kernel")
    dev = sum(o.dur for o in ops)
    if not ops or not dev:
        return None
    rl, pk = run.roofline("attn_density"), run.peaks
    cfg, g = run.cfg, run.geom
    t_min = 0.0
    for s in run.spans.items:
        if s.name != "begin_call" or s.t0 < run.t0 or s.t1 > run.t1:
            continue
        fl, by = rl.extend_cost(cfg, s.info["n0"], s.info["M"],
                                g.bucket(s.info["M"]))
        t_min += cfg.n_layers * max(fl / pk["bf16_flops_per_s"],
                                    by / pk["hbm_bytes_per_s"])
    return 100.0 * t_min / dev
