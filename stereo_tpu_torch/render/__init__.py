"""New-view-synthesis toolbox (the reference's imrender/ojw renderers; port
of stereo_tpu/render).

- :mod:`stereo_tpu_torch.render.genview`   — output-view projection matrices
  (ojw_genview.m, P2stereoP.m, P_interp.m), numpy;
- :mod:`stereo_tpu_torch.render.modes`     — truncated-quadratic colour modes
  (truncquad_modes.cxx) as a dense fixed-capacity tensor program;
- :mod:`stereo_tpu_torch.render.edges`     — pairwise dictionary edge costs
  (truncquad_edges.cxx) as dense min-plus;
- :mod:`stereo_tpu_torch.render.edgemodes` — the CVPR'07 "Pairwise Dictionary
  Priors" renderer (ibr_edgemodes.m) on the TRW/BP table solver;
- :mod:`stereo_tpu_torch.render.occlrender` — the BMVC'07 occlusion-aware
  renderer (ibr_occlrender.m) on QPBO fusion with geometric visibility.

No hand-written kernel runs here: the device work is plain PyTorch, the
QPBO runs on the host.
"""

from stereo_tpu_torch.render.genview import genview, stereo_views, interp_views  # noqa: F401
from stereo_tpu_torch.render.occlrender import (  # noqa: F401
    OcclRenderOptions,
    render_occl,
)
