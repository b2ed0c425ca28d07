// bv_decode_lanes_split: B1 with the preset lanes of split lists
// (kplan.SPLIT_ARCS, kdecode.SplitPlan), the kernel of bv_decode.cu built
// with WG_B1_SPLIT.  A plan with a preset lane launches it; every other
// plan launches bv_decode.cu's own build, whose preprocessed kernel holds
// none of the split code.
#define WG_B1_SPLIT 1
#include "bv_decode.cu"
