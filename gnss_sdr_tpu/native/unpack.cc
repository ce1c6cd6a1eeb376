// Native sample-format converters: interleaved integer IF captures ->
// planar float32 (re, im) for the device pipeline.
//
// Host-side counterpart of the reference's ingest-side native code: the
// VOLK_GNSSSDR type-convert kernels (volk_gnsssdr_8ic_convert_16ic etc.,
// /root/reference/src/algorithms/libs/volk_gnsssdr_module/) and the
// unpack_* GNU Radio blocks
// (src/algorithms/signal_source/gnuradio_blocks/unpack_2bit_samples.cc).
// Plain C loops; the compiler autovectorizes them (SSE/AVX on the host CPU
// feeding the TPU). Exposed via ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdint>

extern "C" {

// interleaved int16 I,Q -> planar float
void ishort_to_planar(const int16_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = static_cast<float>(in[2 * i]);
        im[i] = static_cast<float>(in[2 * i + 1]);
    }
}

// interleaved int8 I,Q -> planar float
void ibyte_to_planar(const int8_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = static_cast<float>(in[2 * i]);
        im[i] = static_cast<float>(in[2 * i + 1]);
    }
}

// interleaved float32 I,Q (gr_complex) -> planar float
void cfloat_to_planar(const float* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

// real int16 -> planar float (Q = 0)
void short_to_planar(const int16_t* in, float* re, float* im, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        re[i] = static_cast<float>(in[i]);
        im[i] = 0.0f;
    }
}

// packed signed 2-bit I/Q pairs (lsb-first fields: I0 Q0 I1 Q1 per byte)
// -> planar float; two complex samples per byte.
// reverse_iq swaps the I/Q roles (unpack_byte_2bit_cpx_samples option).
void unpack2bit_cpx_to_planar(const uint8_t* in, float* re, float* im,
                              size_t n_bytes, int reverse_iq) {
    static const float lut[4] = {0.0f, 1.0f, -2.0f, -1.0f};
    for (size_t i = 0; i < n_bytes; ++i) {
        const uint8_t b = in[i];
        const float s0 = lut[b & 0x3];
        const float s1 = lut[(b >> 2) & 0x3];
        const float s2 = lut[(b >> 4) & 0x3];
        const float s3 = lut[(b >> 6) & 0x3];
        const size_t o = 2 * i;
        if (reverse_iq) {
            re[o] = s1;  im[o] = s0;
            re[o + 1] = s3;  im[o + 1] = s2;
        } else {
            re[o] = s0;  im[o] = s1;
            re[o + 1] = s2;  im[o + 1] = s3;
        }
    }
}

// interleaved float32 I,Q (gr_complex, i.e. complex64 memory layout) ->
// planar int8 with a common scale: the device ingest ring format
// (tracking observables are scale-invariant ratios, see
// FastTrackingEngine superblock_step_i8). One pass, memory-bound.
void cfloat_quantize_i8(const float* in, int8_t* re8, int8_t* im8,
                        size_t n, float q) {
    for (size_t i = 0; i < n; ++i) {
        float r = in[2 * i] * q;
        float m = in[2 * i + 1] * q;
        r = r > 127.0f ? 127.0f : (r < -127.0f ? -127.0f : r);
        m = m > 127.0f ? 127.0f : (m < -127.0f ? -127.0f : m);
        re8[i] = static_cast<int8_t>(r);
        im8[i] = static_cast<int8_t>(m);
    }
}

}  // extern "C"
