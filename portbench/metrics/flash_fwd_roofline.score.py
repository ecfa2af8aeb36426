"""flash_fwd at 128 x 12 x 512 x 512 non-causal: least seconds over traced seconds, percent."""

from portbench.readers import flash_fwd_roofline_score as read  # noqa: F401
