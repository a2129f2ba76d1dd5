from .show import (CrowdPainter, KeypointPainter, arrows, boxes, canvas,
                   circles, draw_limb_offset, heatmap_overlay, image_canvas,
                   load_image, margins, quiver, white_screen)

__all__ = ["CrowdPainter", "KeypointPainter", "arrows", "boxes", "canvas",
           "circles", "draw_limb_offset", "heatmap_overlay", "image_canvas",
           "load_image", "margins", "quiver", "white_screen"]
