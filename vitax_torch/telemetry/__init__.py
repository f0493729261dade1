"""vitax_torch.telemetry: structured observability of training runs
(vitax/telemetry/).

  flops    analytic model FLOPs and the card peak table -> MFU
  sinks    JSONL run log (always on) and an optional TensorBoard mirror
  record   Recorder: schema-1 step records and events fanned out to sinks
  threads  the thread-crash hook (kind "thread_crash") and bounded joins
  watchdog the hang watchdog: stack and memory dump, escalation, exit 42

Wired through train/loop.py (the Recorder's life, a record a log step),
data/loader.py and checkpoint/io.py (their threads report crashes) and
config.py (--metrics_dir, --tensorboard, --peak_tflops). All of it is host
work: the step launches the same kernels with telemetry on or off.
"""

from vitax_torch.telemetry.flops import (  # noqa: F401
    PEAK_TFLOPS, detect_peak_tflops, mfu, model_flops_per_image, model_flops_per_step, peak_tflops)
from vitax_torch.telemetry.record import (  # noqa: F401
    REQUIRED_STEP_KEYS, SCHEMA_VERSION, Recorder, build_recorder, memory_stats_bytes)
from vitax_torch.telemetry.sinks import JsonlSink, TensorBoardSink, make_tensorboard_sink  # noqa: F401
from vitax_torch.telemetry.threads import (  # noqa: F401
    install_thread_excepthook, join_or_warn, report_thread_exception, reporting, restore_thread_excepthook,
    thread_crash_count)
