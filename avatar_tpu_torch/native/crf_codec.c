/* Exact H.264 CRF encode/decode round trip against the system libavcodec
 * (the port's copy of avatar_tpu/native/crf_codec.c).
 *
 * The reference's conditioning-image compressor encodes one frame with
 * libx264 (preset veryfast, yuv420p, CRF c) into an in-memory mp4 and
 * decodes it back to rgb24. Muxing is lossless, so this raw-bitstream round
 * trip is pixel-identical to it given the same libx264. RGB<->YUV
 * conversions use libswscale with SWS_BILINEAR, PyAV's VideoFrame.reformat /
 * to_ndarray defaults.
 *
 * swscale's SIMD rows may read and write past a row's last pixel, so the
 * caller's tightly packed rows go through padded buffers with 64-byte
 * aligned strides (packed rows straight into sws_scale corrupt the heap at
 * widths of 8 modulo 16).
 *
 * Built on first use by avatar_tpu_torch/native/__init__.py (gcc and
 * pkg-config), loaded with ctypes.
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavutil/log.h>
#include <libavutil/mem.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>

__attribute__((constructor)) static void quiet_av_log(void) {
  av_log_set_level(AV_LOG_ERROR); /* x264 stats spam stderr at INFO */
}

/* Round-trip one [height, width, 3] rgb24 image through libx264 at the
 * given CRF.  Returns 0 on success, negative error codes otherwise.
 * width/height must be even (caller crops, as the reference does). */
int avatar_crf_roundtrip_rgb(const uint8_t *rgb, int width, int height,
                             int crf, uint8_t *out_rgb) {
  int ret = -1;
  if (width <= 0 || height <= 0 || (width % 2) || (height % 2)) return -2;

  const AVCodec *enc = avcodec_find_encoder_by_name("libx264");
  const AVCodec *dec = avcodec_find_decoder(AV_CODEC_ID_H264);
  if (!enc || !dec) return -3;

  AVCodecContext *ec = avcodec_alloc_context3(enc);
  AVCodecContext *dc = avcodec_alloc_context3(dec);
  AVFrame *yuv = av_frame_alloc();
  AVFrame *decoded = av_frame_alloc();
  AVPacket *pkt = av_packet_alloc();
  struct SwsContext *to_yuv = NULL, *to_rgb = NULL;
  const int row = 3 * width, stride = (row + 63) / 64 * 64;
  const size_t padded = (size_t)stride * height + 64;
  uint8_t *rgb_in = av_mallocz(padded), *rgb_out = av_mallocz(padded);
  if (!ec || !dc || !yuv || !decoded || !pkt || !rgb_in || !rgb_out) goto done;
  for (int y = 0; y < height; y++)
    memcpy(rgb_in + (size_t)y * stride, rgb + (size_t)y * row, row);

  ec->width = width;
  ec->height = height;
  ec->pix_fmt = AV_PIX_FMT_YUV420P;
  ec->time_base = (AVRational){1, 1}; /* reference: rate=1 */
  {
    char buf[16];
    snprintf(buf, sizeof buf, "%d", crf);
    av_opt_set(ec->priv_data, "crf", buf, 0);
    av_opt_set(ec->priv_data, "preset", "veryfast", 0);
  }
  if (avcodec_open2(ec, enc, NULL) < 0) goto done;
  if (avcodec_open2(dc, dec, NULL) < 0) goto done;

  yuv->format = AV_PIX_FMT_YUV420P;
  yuv->width = width;
  yuv->height = height;
  if (av_frame_get_buffer(yuv, 0) < 0) goto done;

  {
    const uint8_t *src[1] = {rgb_in};
    int src_stride[1] = {stride};
    to_yuv = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                            AV_PIX_FMT_YUV420P, SWS_BILINEAR, NULL, NULL,
                            NULL);
    if (!to_yuv) goto done;
    sws_scale(to_yuv, src, src_stride, 0, height, yuv->data, yuv->linesize);
  }
  yuv->pts = 0;

  /* Encode the frame, then flush; feed every packet straight into the
   * decoder (in-band SPS/PPS: no global-header flag is set). */
  {
    int got = 0;
    for (int phase = 0; phase < 2 && !got; phase++) {
      if (avcodec_send_frame(ec, phase == 0 ? yuv : NULL) < 0) goto done;
      while (avcodec_receive_packet(ec, pkt) == 0) {
        int send = avcodec_send_packet(dc, pkt);
        av_packet_unref(pkt);
        if (send < 0) goto done;
        if (avcodec_receive_frame(dc, decoded) == 0) {
          got = 1;
          break;
        }
      }
    }
    if (!got) { /* drain the decoder */
      avcodec_send_packet(dc, NULL);
      if (avcodec_receive_frame(dc, decoded) != 0) goto done;
    }
  }

  {
    uint8_t *dst[1] = {rgb_out};
    int dst_stride[1] = {stride};
    to_rgb = sws_getContext(width, height, (enum AVPixelFormat)decoded->format,
                            width, height, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                            NULL, NULL, NULL);
    if (!to_rgb) goto done;
    sws_scale(to_rgb, (const uint8_t *const *)decoded->data,
              decoded->linesize, 0, height, dst, dst_stride);
  }
  for (int y = 0; y < height; y++)
    memcpy(out_rgb + (size_t)y * row, rgb_out + (size_t)y * stride, row);
  ret = 0;

done:
  av_free(rgb_in);
  av_free(rgb_out);
  if (to_yuv) sws_freeContext(to_yuv);
  if (to_rgb) sws_freeContext(to_rgb);
  av_packet_free(&pkt);
  av_frame_free(&yuv);
  av_frame_free(&decoded);
  avcodec_free_context(&ec);
  avcodec_free_context(&dc);
  return ret;
}
