"""``python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch CONFIG --test``
— alias for the ``.main`` composition root."""
from .main import cli

if __name__ == "__main__":
    cli()
