"""Whole step's share of the bf16 peak: the semseg's forward FLOPs at
the cell's image size (arith/fcn_r50_d8) times the images of the window,
over the window's seconds times 989 TFLOP/s. ICP and the raster count as
no model FLOPs."""


def read(rec):
    if not rec.get('images') or not rec.get('window_s'):
        return None
    return (100.0 * rec['flops_per_image'] * rec['images']
            / (rec['window_s'] * rec['peak_flops']))
