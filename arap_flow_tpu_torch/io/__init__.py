"""Host IO: .flo codec, Sintel auxiliary formats, PNG/JPEG and mask
conventions, constraint files, .imagedump (numpy only)."""

from .flo import flow_read, flow_write, FLO_TAG_FLOAT, FLO_TAG_BYTES  # noqa: F401
from .sintel import (  # noqa: F401
    depth_read,
    depth_write,
    disparity_read,
    disparity_write,
    cam_read,
    cam_write,
    segmentation_read,
    segmentation_write,
)
from .image import (  # noqa: F401
    ARAP_BG,
    load_rgb,
    load_mask,
    save_image,
    mask_to_arap,
    segment_mask_to_arap,
)
from .constraints import (  # noqa: F401
    read_matches,
    read_constraint_file,
    write_constraint_file,
    filter_matches,
    add_border_pins,
)
from .imagedump import imagedump_read, imagedump_write  # noqa: F401
