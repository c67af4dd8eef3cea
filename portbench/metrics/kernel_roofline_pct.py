"""The sampling phase's share of its roofline: the least time its work
needs on the card (the largest of its float32 operations over the float32
peak, its special-function results over their rate and its bytes over the
memory bandwidth; portbench/work.py and the configuration's count) over
the device time of the kernels the profiler names for it, over the traced
fits.  Which of the three binds is noted in the run's result."""

from portbench.work import kernel_work, least_time

KERNELS = ("fused_hmc_kernel", "rt_row_consts_kernel")


def read(run):
    if run.activity is None or run.peaks is None:
        return None
    seconds = run.activity.device_seconds(KERNELS)
    if seconds <= 0:
        return None
    t = run.traffic
    least, binds = least_time(*kernel_work(
        run.work, t["chains"], t["draws"], t["hmc_steps"], run.n_collect),
        run.peaks)
    run.notes["kernel_roofline_binds"] = binds
    return 100.0 * least * run.activity.n_fits / seconds
