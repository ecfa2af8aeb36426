"""flash_fwd, flash_bwd_dq and flash_bwd_dkv: least seconds over traced seconds, percent."""

from portbench.readers import flash_roofline_train as read  # noqa: F401
