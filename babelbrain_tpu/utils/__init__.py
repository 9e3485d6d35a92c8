from .timing import (  # noqa: F401
    clear_spans,
    open_spans,
    recorded_spans,
    stage_timer,
)
