/*!
 * Smoke test of the port's C ABI from a pure-C host (no Python in
 * main()): builds a synthetic-data iterator and a small MLP, trains a
 * few rounds, evaluates, predicts, and round-trips a weight.  Mirrors
 * what a non-Python embedder of the reference did through
 * cxxnet_wrapper.h.
 *
 *   capi_smoke [device]
 *
 * The device (argv[1]) is "cpu" by default; "gpu" runs the net on the
 * card.  The checkpoint round trip writes into $TMPDIR (else /tmp).
 * Built by cxxnet_tpu_torch/ops/_build.py (build_host); exits non-zero
 * on any failure.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "cxxnet_capi.h"

#define CHECK(cond)                                                  \
  do {                                                               \
    if (!(cond)) {                                                   \
      fprintf(stderr, "CHECK failed at %s:%d: %s\nlast error: %s\n", \
              __FILE__, __LINE__, #cond, CXNGetLastError());         \
      exit(1);                                                       \
    }                                                                \
  } while (0)

static const char *kIterCfg =
    "iter = synthetic\n"
    "  nsample = 64\n"
    "  input_shape = 1,1,8\n"
    "  nclass = 4\n"
    "  seed = 3\n"
    "batch_size = 16\n"
    "input_shape = 1,1,8\n";

static const char *kNetCfg =
    "netconfig = start\n"
    "layer[0->1] = fullc:fc1\n"
    "  nhidden = 32\n"
    "  init_sigma = 0.1\n"
    "layer[1->2] = relu\n"
    "layer[2->3] = fullc:fc2\n"
    "  nhidden = 4\n"
    "  init_sigma = 0.1\n"
    "layer[3->3] = softmax\n"
    "netconfig = end\n"
    "input_shape = 1,1,8\n"
    "batch_size = 16\n"
    "eta = 0.3\n"
    "momentum = 0.9\n"
    "metric = error\n";

int main(int argc, char **argv) {
  const char *dev = argc > 1 ? argv[1] : "cpu";
  const char *tmpdir = getenv("TMPDIR");
  char model_path[4096];
  snprintf(model_path, sizeof(model_path), "%s/capi_smoke_%ld.model",
           tmpdir && *tmpdir ? tmpdir : "/tmp", (long)getpid());
  fprintf(stderr, "capi_smoke: device %s\n", dev);

  void *it = CXNIOCreateFromConfig(kIterCfg);
  CHECK(it != NULL);

  void *net = CXNNetCreate(dev, kNetCfg);
  CHECK(net != NULL);
  CHECK(CXNNetSetParam(net, "eval_train", "0") == 0);
  CHECK(CXNNetInitModel(net) == 0);

  /* a few training epochs straight off the iterator */
  for (int round = 0; round < 12; ++round) {
    CHECK(CXNNetStartRound(net, round) == 0);
    CXNIOBeforeFirst(it);
    int n;
    while ((n = CXNIONext(it)) == 1) {
      CHECK(CXNNetUpdateIter(net, it) == 0);
    }
    CHECK(n == 0);
  }

  /* evaluate: reference line format "\tname-metric:value" */
  const char *line = CXNNetEvaluate(net, it, "smoke");
  CHECK(line != NULL);
  CHECK(strstr(line, "smoke-error:") != NULL);
  double err = atof(strstr(line, "smoke-error:") + strlen("smoke-error:"));
  fprintf(stderr, "eval:%s -> err %.4f\n", line, err);
  CHECK(err < 0.5); /* learned something on the synthetic task */

  /* predict on the iterator's current batch buffers */
  CXNIOBeforeFirst(it);
  CHECK(CXNIONext(it) == 1);
  cxx_uint dshape[4], lshape[2], stride, nout;
  const cxx_real_t *data = CXNIOGetData(it, dshape, &stride);
  const cxx_real_t *label = CXNIOGetLabel(it, lshape, &stride);
  CHECK(data != NULL && label != NULL);
  CHECK(dshape[0] == 16 && dshape[3] == 8);
  CHECK(lshape[0] == 16);
  const cxx_real_t *pred = CXNNetPredictBatch(net, data, dshape, &nout);
  CHECK(pred != NULL && nout == 16);
  for (cxx_uint i = 0; i < nout; ++i) {
    CHECK(pred[i] >= 0.0f && pred[i] <= 3.0f);
  }

  /* batch-update path with raw buffers */
  CHECK(CXNNetUpdateBatch(net, data, dshape, label, lshape) == 0);

  /* feature extraction from a named node */
  cxx_uint eshape[2];
  const cxx_real_t *feat = CXNNetExtractBatch(net, data, dshape, "2", eshape);
  CHECK(feat != NULL && eshape[0] == 16 && eshape[1] == 32);

  /* weight round-trip through the 2-D visitor view */
  cxx_uint wshape[2];
  const cxx_real_t *w = CXNNetGetWeight(net, "fc2", "wmat", wshape);
  CHECK(w != NULL && wshape[0] == 4 && wshape[1] == 32);
  float *w2 = (float *)malloc(sizeof(float) * wshape[0] * wshape[1]);
  memcpy(w2, w, sizeof(float) * wshape[0] * wshape[1]);
  w2[0] += 1.0f;
  CHECK(CXNNetSetWeight(net, w2, wshape[0] * wshape[1], "fc2", "wmat") == 0);
  const cxx_real_t *w3 = CXNNetGetWeight(net, "fc2", "wmat", wshape);
  CHECK(w3 != NULL && w3[0] > w2[0] - 1.5f && w3[0] < w2[0] + 0.5f);
  free(w2);

  /* missing weight -> NULL (reference behavior), not a fake buffer */
  cxx_uint mshape[2];
  CHECK(CXNNetGetWeight(net, "no_such_layer", "wmat", mshape) == NULL);

  /* checkpoint round-trip */
  CHECK(CXNNetSaveModel(net, model_path) == 0);
  void *net2 = CXNNetCreate(dev, kNetCfg);
  CHECK(net2 != NULL);
  CHECK(CXNNetLoadModel(net2, model_path) == 0);
  const cxx_real_t *pred2 = CXNNetPredictBatch(net2, data, dshape, &nout);
  CHECK(pred2 != NULL && nout == 16);
  CXNNetFree(net2);
  remove(model_path);
  strncat(model_path, ".manifest.json",
          sizeof(model_path) - strlen(model_path) - 1);
  remove(model_path);

  /* error path: bad layer type must fail at init with a message set
   * (config is parsed lazily, reference SetParam semantics), not crash */
  void *bad = CXNNetCreate(dev,
                           "netconfig = start\nlayer[0->1] = nope\n"
                           "netconfig = end\ninput_shape = 1,1,8\n"
                           "batch_size = 16\n");
  CHECK(bad != NULL);
  CHECK(CXNNetInitModel(bad) != 0);
  CHECK(strlen(CXNGetLastError()) > 0);
  CXNNetFree(bad);

  CXNNetFree(net);
  CXNIOFree(it);
  fprintf(stderr, "capi_smoke: all checks passed\n");
  return 0;
}
