"""Rows 2 and 3 in the trace: each launch's operand split
(``split_se_kernel``) runs directly before its main kernel."""

from gpbench.counts.bounds import epilogue_bounds

FWD = dict(core=r"epilogue_fwd_mma", lead=r"split_se_kernel")
BWD = dict(core=r"w_tiles_mma", lead=r"split_se_kernel",
           tail=r"pad_points|se_bar_mma|finish_z|finish_se")


def roofline(view, which: str):
    key = "svgp_data_epilogue" if which == "fwd" else "svgp_data_epilogue_bwd"
    shapes = view.done.get("launches", {}).get(key, [])
    least = [epilogue_bounds(which, m, b, d)[0][0] for m, b, d in shapes]
    return view.roofline(least, view.trace.launches(**(FWD if which == "fwd" else BWD)))
