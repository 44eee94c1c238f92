// The inner loops of COCO bbox evaluation and a host NMS (counterpart of
// the JAX package's native/ait_native.cpp), in double precision with the
// same operations: ait_tpu_torch/evaluation/coco_eval.py sends its
// pairwise IoU and greedy matching here.  A plain C interface, bound with
// ctypes by ait_tpu_torch/native.py and built with g++ by ops/_build.py
// (-ffp-contract=off: every product and sum rounded on its own, as numpy
// rounds them).

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Pairwise IoU of xywh boxes.  crowd gt uses union = det area (the COCO
// crowd convention).  out is [n_dt, n_gt] row-major.
void ait_bbox_iou_xywh(int64_t n_dt, const double* dt,
                       int64_t n_gt, const double* gt,
                       const uint8_t* iscrowd, double* out) {
  for (int64_t i = 0; i < n_dt; ++i) {
    const double dx1 = dt[i * 4 + 0], dy1 = dt[i * 4 + 1];
    const double dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    const double dx2 = dx1 + dw, dy2 = dy1 + dh;
    const double darea = dw * dh;
    for (int64_t j = 0; j < n_gt; ++j) {
      const double gx1 = gt[j * 4 + 0], gy1 = gt[j * 4 + 1];
      const double gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      const double iw =
          std::min(dx2, gx1 + gw) - std::max(dx1, gx1);
      const double ih =
          std::min(dy2, gy1 + gh) - std::max(dy1, gy1);
      double iou = 0.0;
      if (iw > 0 && ih > 0) {
        const double inter = iw * ih;
        const double uni = iscrowd[j] ? darea : darea + gw * gh - inter;
        if (uni > 0) iou = inter / uni;
      }
      out[i * n_gt + j] = iou;
    }
  }
}

// Greedy matching of detections (already score-sorted) to gts (already
// sorted ignore-last) at each IoU threshold.
//   ious:      [n_dt, n_gt]
//   gt_ignore: [n_gt]   (area-range / crowd ignore)
//   iscrowd:   [n_gt]
//   dtm:       [n_thr, n_dt] out — matched gt index + 1, or 0
//   dt_ignore: [n_thr, n_dt] out — 1 if matched to an ignored gt
void ait_greedy_match(int64_t n_thr, const double* thrs,
                      int64_t n_dt, int64_t n_gt, const double* ious,
                      const uint8_t* gt_ignore, const uint8_t* iscrowd,
                      int64_t* dtm, uint8_t* dt_ignore) {
  // per-threshold gt-matched scratch
  int64_t* gtm = new int64_t[n_gt];
  for (int64_t t = 0; t < n_thr; ++t) {
    std::memset(gtm, 0, sizeof(int64_t) * n_gt);
    const double thr = thrs[t];
    for (int64_t d = 0; d < n_dt; ++d) {
      double best = std::min(thr, 1.0 - 1e-10);
      int64_t m = -1;
      for (int64_t g = 0; g < n_gt; ++g) {
        if (gtm[g] > 0 && !iscrowd[g]) continue;
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        const double iou = ious[d * n_gt + g];
        if (iou < best) continue;
        best = iou;
        m = g;
      }
      if (m > -1) {
        dtm[t * n_dt + d] = m + 1;
        gtm[m] = d + 1;
        dt_ignore[t * n_dt + d] = gt_ignore[m];
      } else {
        dtm[t * n_dt + d] = 0;
        dt_ignore[t * n_dt + d] = 0;
      }
    }
  }
  delete[] gtm;
}

// Greedy VOC-style NMS over score-sorted xyxy boxes (+1 area convention,
// matching lib/model/csrc/cuda/nms.cu:16-19).  keep_out: [n] 0/1.
// Used by host-side tooling; the device path uses csrc/nms.cu.
void ait_nms_xyxy(int64_t n, const double* boxes, double thresh,
                  uint8_t* keep_out) {
  for (int64_t i = 0; i < n; ++i) keep_out[i] = 1;
  for (int64_t i = 0; i < n; ++i) {
    if (!keep_out[i]) continue;
    const double x1 = boxes[i * 4], y1 = boxes[i * 4 + 1];
    const double x2 = boxes[i * 4 + 2], y2 = boxes[i * 4 + 3];
    const double area_i = (x2 - x1 + 1) * (y2 - y1 + 1);
    for (int64_t j = i + 1; j < n; ++j) {
      if (!keep_out[j]) continue;
      const double xx1 = std::max(x1, boxes[j * 4]);
      const double yy1 = std::max(y1, boxes[j * 4 + 1]);
      const double xx2 = std::min(x2, boxes[j * 4 + 2]);
      const double yy2 = std::min(y2, boxes[j * 4 + 3]);
      const double w = std::max(0.0, xx2 - xx1 + 1);
      const double h = std::max(0.0, yy2 - yy1 + 1);
      const double inter = w * h;
      const double area_j = (boxes[j * 4 + 2] - boxes[j * 4] + 1) *
                            (boxes[j * 4 + 3] - boxes[j * 4 + 1] + 1);
      if (inter / (area_i + area_j - inter) > thresh) keep_out[j] = 0;
    }
  }
}

}  // extern "C"
