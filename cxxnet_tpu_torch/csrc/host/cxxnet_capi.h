/*!
 * C ABI for the cxxnet-tpu framework — the non-Python host surface.
 *
 * Parity: /root/reference/wrapper/cxxnet_wrapper.h:36-230 (CXNIO* data
 * iterator + CXNNet* trainer families).  Implemented by embedding
 * CPython (native/cxxnet_capi.cc): the library initializes an
 * interpreter on first use, imports cxxnet_tpu.capi_shim, and forwards
 * each call.  The compute still runs the framework's jitted XLA
 * programs — this is a host-language binding, not a second engine.
 *
 * Layout note: the reference is NCHW; this framework is NHWC
 * (TPU-native).  4-D shapes are (n, h, w, c); flat data is
 * (n, 1, 1, d).  All buffers are C-contiguous float32 and remain valid
 * until the next call on the same handle (reference temp-buffer rule).
 *
 * Errors: failed calls return NULL/-1 and set a message readable with
 * CXNGetLastError() (the reference aborted the process instead).
 */
#ifndef CXXNET_TPU_CAPI_H_
#define CXXNET_TPU_CAPI_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef float cxx_real_t;
typedef unsigned cxx_uint;

/*! \brief message for the last failed call on this thread */
const char *CXNGetLastError(void);

/* ------------------------------------------------------ data iterator */
/*! \brief create an io iterator from a config string (iter = ... blocks) */
void *CXNIOCreateFromConfig(const char *cfg);
/*! \brief move to the next batch; returns 0 at end of epoch, -1 on error */
int CXNIONext(void *handle);
/*! \brief rewind the iterator */
void CXNIOBeforeFirst(void *handle);
/*! \brief current batch data; fills oshape[4] = (n, h, w, c) */
const cxx_real_t *CXNIOGetData(void *handle, cxx_uint oshape[4],
                               cxx_uint *ostride);
/*! \brief current batch labels; fills oshape[2] = (n, label_width) */
const cxx_real_t *CXNIOGetLabel(void *handle, cxx_uint oshape[2],
                                cxx_uint *ostride);
/*! \brief free the iterator handle */
void CXNIOFree(void *handle);

/* -------------------------------------------------------------- net */
/*! \brief create a net; device may be NULL (config decides) */
void *CXNNetCreate(const char *device, const char *cfg);
void CXNNetFree(void *handle);
int CXNNetSetParam(void *handle, const char *name, const char *val);
int CXNNetInitModel(void *handle);
int CXNNetSaveModel(void *handle, const char *fname);
int CXNNetLoadModel(void *handle, const char *fname);
int CXNNetStartRound(void *handle, int round);
/*! \brief one training step on a raw batch: data (n, h, w, c) or
 *  (n, 1, 1, d) flat, labels (n, label_width) */
int CXNNetUpdateBatch(void *handle, const cxx_real_t *p_data,
                      const cxx_uint dshape[4], const cxx_real_t *p_label,
                      const cxx_uint lshape[2]);
/*! \brief one training step consuming the iterator's current batch */
int CXNNetUpdateIter(void *handle, void *data_handle);
/*! \brief per-instance predictions (argmax / raw value), length *out_size */
const cxx_real_t *CXNNetPredictBatch(void *handle, const cxx_real_t *p_data,
                                     const cxx_uint dshape[4],
                                     cxx_uint *out_size);
const cxx_real_t *CXNNetPredictIter(void *handle, void *data_handle,
                                    cxx_uint *out_size);
/*! \brief extract a named node's activations, (n, feature) flattened */
const cxx_real_t *CXNNetExtractBatch(void *handle, const cxx_real_t *p_data,
                                     const cxx_uint dshape[4],
                                     const char *node_name,
                                     cxx_uint oshape[2]);
const cxx_real_t *CXNNetExtractIter(void *handle, void *data_handle,
                                    const char *node_name,
                                    cxx_uint oshape[2]);
/*! \brief run the metric set over an eval iterator; returns the
 *  "\tname-metric:value" line (reference format) */
const char *CXNNetEvaluate(void *handle, void *data_handle,
                           const char *data_name);
/*! \brief set a weight from a 2-D view (reference visitor layout) */
int CXNNetSetWeight(void *handle, const cxx_real_t *p_weight,
                    cxx_uint size_weight, const char *layer_name,
                    const char *wtag);
/*! \brief get a weight as a 2-D view; fills oshape[2] */
const cxx_real_t *CXNNetGetWeight(void *handle, const char *layer_name,
                                  const char *wtag, cxx_uint oshape[2]);

#ifdef __cplusplus
}
#endif
#endif  /* CXXNET_TPU_CAPI_H_ */
