"""QA benchmark inference (``inference``) and its judge (``evaluate``)."""
