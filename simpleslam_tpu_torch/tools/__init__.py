"""Tools: the synthetic corridor renderer and trajectory evaluation."""
