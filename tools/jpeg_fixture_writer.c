/* Writes the JPEG fixtures that Pillow cannot write, through libjpeg(-turbo)'s
 * compressor: arithmetic coding (sequential and progressive, with chosen DAC
 * conditioning), any sampling factors, YCCK and CMYK, restart intervals and a
 * progressive scan script that leaves the low AC coefficients unrefined.
 *
 *   jpeg_fixture_writer OUT RAW W H SPACE QUALITY ARITH PROGRESSION SAMPLING
 *                       RESTART_ROWS DC_L DC_U AC_K
 *
 * RAW holds W*H pixels of 1 (SPACE gray), 3 (rgb, ycc) or 4 (cmyk, ycck) bytes.
 * SPACE: gray | rgb (stored as RGB) | ycc (RGB stored as YCbCr) | cmyk | ycck.
 * PROGRESSION: 0 sequential, 1 jpeg_simple_progression, 2 the simple script
 * cut after the scans at Al = 1 (no AC refinement scans).
 * SAMPLING: "HxV,HxV,..." per component. DC_L, DC_U, AC_K: the arithmetic
 * conditioning of every table (libjpeg's defaults are 0 1 5).
 *
 * Built by tools/make_image_fixtures.py with
 *   gcc -O2 jpeg_fixture_writer.c -ljpeg
 * against the system's libjpeg-turbo (C_ARITH_CODING_SUPPORTED). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static void cut_script(j_compress_ptr c) {
  /* jpeg_simple_progression's script minus its refinement scans (Ah > 0):
   * DC at Al 1, AC at Al 2 or 1, so coefficients stay unrefined */
  int n = 0, i;
  jpeg_scan_info *kept;
  jpeg_simple_progression(c);
  kept = (jpeg_scan_info *)malloc(sizeof(jpeg_scan_info) * c->num_scans);
  for (i = 0; i < c->num_scans; i++)
    if (c->scan_info[i].Ah == 0) kept[n++] = c->scan_info[i];
  c->scan_info = kept;
  c->num_scans = n;
}

int main(int argc, char **argv) {
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  FILE *in, *out;
  unsigned char *pixels;
  int W, H, comps, quality, arith, progression, restart_rows, i;
  const char *space, *sampling;
  if (argc != 14) {
    fprintf(stderr, "usage: %s OUT RAW W H SPACE QUALITY ARITH PROGRESSION SAMPLING "
            "RESTART_ROWS DC_L DC_U AC_K\n", argv[0]);
    return 2;
  }
  W = atoi(argv[3]);
  H = atoi(argv[4]);
  space = argv[5];
  quality = atoi(argv[6]);
  arith = atoi(argv[7]);
  progression = atoi(argv[8]);
  sampling = argv[9];
  restart_rows = atoi(argv[10]);
  comps = !strcmp(space, "gray") ? 1 : (!strcmp(space, "cmyk") || !strcmp(space, "ycck")) ? 4 : 3;
  pixels = (unsigned char *)malloc((size_t)W * H * comps);
  in = fopen(argv[2], "rb");
  if (!in || fread(pixels, 1, (size_t)W * H * comps, in) != (size_t)W * H * comps) {
    fprintf(stderr, "cannot read %s\n", argv[2]);
    return 1;
  }
  fclose(in);
  out = fopen(argv[1], "wb");
  if (!out) return 1;

  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = W;
  c.image_height = H;
  c.input_components = comps;
  c.in_color_space = comps == 1 ? JCS_GRAYSCALE : comps == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&c);
  if (!strcmp(space, "rgb")) jpeg_set_colorspace(&c, JCS_RGB);
  if (!strcmp(space, "ycck")) jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, quality, TRUE);
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = FALSE;
  for (i = 0; i < NUM_ARITH_TBLS; i++) {
    c.arith_dc_L[i] = (UINT8)atoi(argv[11]);
    c.arith_dc_U[i] = (UINT8)atoi(argv[12]);
    c.arith_ac_K[i] = (UINT8)atoi(argv[13]);
  }
  for (i = 0; i < c.num_components && *sampling; i++) {
    int h = 1, v = 1;
    sscanf(sampling, "%dx%d", &h, &v);
    c.comp_info[i].h_samp_factor = h;
    c.comp_info[i].v_samp_factor = v;
    sampling = strchr(sampling, ',');
    sampling = sampling ? sampling + 1 : "";
  }
  c.restart_in_rows = restart_rows;
  if (progression == 1) jpeg_simple_progression(&c);
  if (progression == 2) cut_script(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pixels + (size_t)c.next_scanline * W * comps;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(pixels);
  return 0;
}
