"""Host-side visualization: the reference's ``graficar`` as library functions.

Port of ``raytracing_tpu/viz/plots.py`` (``plots``): the trajectory plots
over a pcolormesh of n, the PCHIP wavefront reconstruction with its
ray-angle-against-wavefront-normal check, the wavefront movie and the
momentum, eigenray, transmission-loss and 3-D trajectory plots.  The
analysis (``ray_xy``, ``wavefront``, ``wavefront_report``) needs numpy and
scipy only; matplotlib is imported only when something is drawn.
"""
