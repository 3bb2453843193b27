// Fast COCO evaluation kernels — the TPU-era counterpart of the
// reference's detectron2-derived C++ COCOeval (detection/YOLOX/yolox/
// layers/csrc/cocoeval/cocoeval.cpp, exposed as yolox._C). Same role —
// move the O(thresholds × dets × gts) greedy matching and the
// precision-accumulation inner loops out of Python — but bound via a
// plain C ABI + ctypes instead of pybind11 (not available in this image).
//
// Semantics mirror pycocotools COCOeval::evaluateImg/accumulate:
//  * detections greedily match the best remaining gt with IoU >= thr;
//    crowd gts may match repeatedly (IoA); ignored gts are only taken
//    when no real gt qualifies; once a det has a real match it never
//    switches to an ignored gt.
//  * unmatched detections outside the area range are ignored.
//
// Built by native/build.py: g++ -O3 -shared -fPIC cocoeval.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// IoU between det and gt boxes (xyxy); crowd gt uses intersection/det_area.
static inline double box_iou_one(const double* d, const double* g,
                                 bool crowd) {
  const double ix1 = std::max(d[0], g[0]);
  const double iy1 = std::max(d[1], g[1]);
  const double ix2 = std::min(d[2], g[2]);
  const double iy2 = std::min(d[3], g[3]);
  const double iw = std::max(0.0, ix2 - ix1);
  const double ih = std::max(0.0, iy2 - iy1);
  const double inter = iw * ih;
  if (inter <= 0) return 0.0;
  const double ad = std::max(0.0, d[2] - d[0]) * std::max(0.0, d[3] - d[1]);
  const double ag = std::max(0.0, g[2] - g[0]) * std::max(0.0, g[3] - g[1]);
  const double uni = crowd ? ad : (ad + ag - inter);
  return uni <= 0 ? 0.0 : inter / uni;
}

// Match all images of one (category, area range, maxDet) slice.
// Arrays are packed: image i's dets are [d_off[i], d_off[i+1]).
// Gts must be pre-sorted per image with non-ignored first.
// Outputs: dt_matched (n_thr, total_d) gt local index or -1;
//          dt_ignore  (n_thr, total_d) 0/1.
void coco_match(int n_img, const int64_t* d_off, const int64_t* g_off,
                const double* d_boxes, const double* g_boxes,
                const uint8_t* g_crowd, const uint8_t* g_ignore,
                const double* iou_thrs, int n_thr, double area_lo,
                double area_hi, int64_t total_d, int64_t* dt_matched,
                uint8_t* dt_ignore) {
  for (int64_t i = 0; i < (int64_t)n_thr * total_d; ++i) dt_matched[i] = -1;
  for (int64_t i = 0; i < (int64_t)n_thr * total_d; ++i) dt_ignore[i] = 0;

  std::vector<int64_t> gt_taken;
  for (int img = 0; img < n_img; ++img) {
    const int64_t d0 = d_off[img], d1 = d_off[img + 1];
    const int64_t g0 = g_off[img], g1 = g_off[img + 1];
    const int64_t gcount = g1 - g0;
    for (int t = 0; t < n_thr; ++t) {
      const double thr = iou_thrs[t];
      gt_taken.assign(gcount, -1);
      for (int64_t di = d0; di < d1; ++di) {
        double best_iou = std::min(thr, 1.0 - 1e-10);
        int64_t best_g = -1;
        for (int64_t gi = 0; gi < gcount; ++gi) {
          const bool crowd = g_crowd[g0 + gi] != 0;
          if (gt_taken[gi] >= 0 && !crowd) continue;
          const bool ign = g_ignore[g0 + gi] != 0;
          if (best_g >= 0 && !g_ignore[g0 + best_g] && ign) break;
          const double iou =
              box_iou_one(d_boxes + 4 * di, g_boxes + 4 * (g0 + gi), crowd);
          if (iou < best_iou) continue;
          best_iou = iou;
          best_g = gi;
        }
        if (best_g >= 0) {
          gt_taken[best_g] = di;
          dt_matched[(int64_t)t * total_d + di] = best_g;
          dt_ignore[(int64_t)t * total_d + di] = g_ignore[g0 + best_g];
        } else {
          const double* b = d_boxes + 4 * di;
          const double area = std::max(0.0, b[2] - b[0]) *
                              std::max(0.0, b[3] - b[1]);
          if (area < area_lo || area > area_hi)
            dt_ignore[(int64_t)t * total_d + di] = 1;
        }
      }
    }
  }
}

}  // extern "C"
