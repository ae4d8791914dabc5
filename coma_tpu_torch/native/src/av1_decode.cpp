// AV1 decoding of coded-lossless intra frames, as dav1d 1.5.1 decodes them
// for libavif 1.3.0 and Pillow 12.1.0, for coma_tpu_torch/utils/avif.py: the
// OBUs of an AVIF item, the sequence header, the uncompressed header of the
// first shown frame (a key frame), its tile groups, and every tile: the
// symbol decoder with CDF adaptation, partitions, intra frame mode info
// (segment id, skip, y and uv modes, angle deltas, CFL alphas, filter intra),
// the TX_4X4 coefficients of q context 0, the inverse Walsh-Hadamard
// transform, and every intra predictor with the intra edge filter and
// upsampling. Each process is named as in the AV1 Bitstream & Decoding
// Process Specification (v1.0.0 with Errata 1), where its text is found.
// Then libyuv's colour conversion of the planes, as libavif calls it.
//
// A frame that is not CodedLossless, or that uses screen content tools,
// superres, film grain, a bit depth above 8, or is not a shown key frame is
// refused with a code (utils/avif.py names it); without quantisation every
// frame of that kind has no loop filter, CDEF or loop restoration to apply,
// and every transform block is a 4x4 Walsh-Hadamard one. A damaged tile
// never reads outside its bytes: the symbol decoder reads zeros past its
// end, as the specification's does.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 av1_decode.cpp (native/__init__.py
// does it at first use).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Default CDFs (the specification's Default_*_Cdf tables), cumulative, each
// row without its closing 32768 and its counter. q context 0 only for the
// coefficient CDFs, and of those only TX_4X4's (txSzCtx 0).
// ---------------------------------------------------------------------------

static const uint16_t kPartitionW8[4][3] = {
    {19132, 25510, 30392}, {13928, 19855, 28540}, {12522, 23679, 28629}, {9896, 18783, 25853}};
static const uint16_t kPartitionW16[4][9] = {
    {15597, 20929, 24571, 26706, 27664, 28821, 29601, 30571, 31902},
    {7925, 11043, 16785, 22470, 23971, 25043, 26651, 28701, 29834},
    {5414, 13269, 15111, 20488, 22360, 24500, 25537, 26336, 32117},
    {2662, 6362, 8614, 20860, 23053, 24778, 26436, 27829, 31171}};
static const uint16_t kPartitionW32[4][9] = {
    {18462, 20920, 23124, 27647, 28227, 29049, 29519, 30178, 31544},
    {7689, 9060, 12056, 24992, 25660, 26182, 26951, 28041, 29052},
    {6015, 9009, 10062, 24544, 25409, 26545, 27071, 27526, 32047},
    {1394, 2208, 2796, 28614, 29061, 29466, 29840, 30185, 31899}};
static const uint16_t kPartitionW64[4][9] = {
    {20137, 21547, 23078, 29566, 29837, 30261, 30524, 30892, 31724},
    {6732, 7490, 9497, 27944, 28250, 28515, 28969, 29630, 30104},
    {5945, 7663, 8348, 28683, 29117, 29749, 30064, 30298, 32238},
    {870, 1212, 1487, 31198, 31394, 31574, 31743, 31881, 32332}};
static const uint16_t kPartitionW128[4][7] = {
    {27899, 28219, 28529, 32484, 32539, 32619, 32639},
    {6607, 6990, 8268, 32060, 32219, 32338, 32371},
    {5429, 6676, 7122, 32027, 32227, 32531, 32582},
    {711, 966, 1172, 32448, 32538, 32617, 32664}};

static const uint16_t kKfYMode[5][5][12] = {
    {{15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093, 30466},
     {12016, 18066, 19516, 20303, 20719, 21444, 21888, 23032, 24434, 28658, 30172, 31409},
     {10052, 10771, 22296, 22788, 23055, 23239, 24133, 25620, 26160, 29336, 29929, 31567},
     {14091, 15406, 16442, 18808, 19136, 19546, 19998, 22096, 24746, 29585, 30958, 32462},
     {12122, 13265, 15603, 16501, 18609, 20033, 22391, 25583, 26437, 30261, 31073, 32475}},
    {{10023, 19585, 20848, 21440, 21832, 22760, 23089, 24023, 25381, 29014, 30482, 31436},
     {5983, 24099, 24560, 24886, 25066, 25795, 25913, 26423, 27610, 29905, 31276, 31794},
     {7444, 12781, 20177, 20728, 21077, 21607, 22170, 23405, 24469, 27915, 29090, 30492},
     {8537, 14689, 15432, 17087, 17408, 18172, 18408, 19825, 24649, 29153, 31096, 32210},
     {7543, 14231, 15496, 16195, 17905, 20717, 21984, 24516, 26001, 29675, 30981, 31994}},
    {{12613, 13591, 21383, 22004, 22312, 22577, 23401, 25055, 25729, 29538, 30305, 32077},
     {9687, 13470, 18506, 19230, 19604, 20147, 20695, 22062, 23219, 27743, 29211, 30907},
     {6183, 6505, 26024, 26252, 26366, 26434, 27082, 28354, 28555, 30467, 30794, 32086},
     {10718, 11734, 14954, 17224, 17565, 17924, 18561, 21523, 23878, 28975, 30287, 32252},
     {9194, 9858, 16501, 17263, 18424, 19171, 21563, 25961, 26561, 30072, 30737, 32463}},
    {{12602, 14399, 15488, 18381, 18778, 19315, 19724, 21419, 25060, 29696, 30917, 32409},
     {8203, 13821, 14524, 17105, 17439, 18131, 18404, 19468, 25225, 29485, 31158, 32342},
     {8451, 9731, 15004, 17643, 18012, 18425, 19070, 21538, 24605, 29118, 30078, 32018},
     {7714, 9048, 9516, 16667, 16817, 16994, 17153, 18767, 26743, 30389, 31536, 32528},
     {8843, 10280, 11496, 15317, 16652, 17943, 19108, 22718, 25769, 29953, 30983, 32485}},
    {{12578, 13671, 15979, 16834, 19075, 20913, 22989, 25449, 26219, 30214, 31150, 32477},
     {9563, 13626, 15080, 15892, 17756, 20863, 22207, 24236, 25380, 29653, 31143, 32277},
     {8356, 8901, 17616, 18256, 19350, 20106, 22598, 25947, 26466, 29900, 30523, 32261},
     {10835, 11815, 13124, 16042, 17018, 18039, 18947, 22753, 24615, 29489, 30883, 32482},
     {7618, 8288, 9859, 10509, 15386, 18657, 22903, 28776, 29180, 31355, 31802, 32593}}};

static const uint16_t kUvModeNoCfl[13][12] = {
    {22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244, 30059, 30941, 31961},
    {9513, 26881, 26973, 27046, 27118, 27664, 27739, 27824, 28359, 29505, 29800, 31796},
    {9845, 9915, 28663, 28704, 28757, 28780, 29198, 29822, 29854, 30764, 31777, 32029},
    {13639, 13897, 14171, 25331, 25606, 25727, 25953, 27148, 28577, 30612, 31355, 32493},
    {9764, 9835, 9930, 9954, 25386, 27053, 27958, 28148, 28243, 31101, 31744, 32363},
    {11825, 13589, 13677, 13720, 15048, 29213, 29301, 29458, 29711, 31161, 31441, 32550},
    {14175, 14399, 16608, 16821, 17718, 17775, 28551, 30200, 30245, 31837, 32342, 32667},
    {12885, 13038, 14978, 15590, 15673, 15748, 16176, 29128, 29267, 30643, 31961, 32461},
    {12026, 13661, 13874, 15305, 15490, 15726, 15995, 16273, 28443, 30388, 30767, 32416},
    {19052, 19840, 20579, 20916, 21150, 21467, 21885, 22719, 23174, 28861, 30379, 32175},
    {18627, 19649, 20974, 21219, 21492, 21816, 22199, 23119, 23527, 27053, 31397, 32148},
    {17026, 19004, 19997, 20339, 20586, 21103, 21349, 21907, 22482, 25896, 26541, 31819},
    {12124, 13759, 14959, 14992, 15007, 15051, 15078, 15166, 15255, 15753, 16039, 16606}};
static const uint16_t kUvModeCfl[13][13] = {
    {10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986, 20086, 20995, 22455, 24212},
    {4532, 19780, 20057, 20215, 20428, 21071, 21199, 21451, 22099, 24228, 24693, 27032, 29472},
    {5273, 5379, 20177, 20270, 20385, 20439, 20949, 21695, 21774, 23138, 24256, 24703, 26679},
    {6740, 7167, 7662, 14152, 14536, 14785, 15034, 16741, 18371, 21520, 22206, 23389, 24182},
    {4987, 5368, 5928, 6068, 19114, 20315, 21857, 22253, 22411, 24911, 25380, 26027, 26376},
    {5370, 6889, 7247, 7393, 9498, 21114, 21402, 21753, 21981, 24780, 25386, 26517, 27176},
    {4816, 4961, 7204, 7326, 8765, 8930, 20169, 20682, 20803, 23188, 23763, 24455, 24940},
    {6608, 6740, 8529, 9049, 9257, 9356, 9735, 18827, 19059, 22336, 23204, 23964, 24793},
    {5998, 7419, 7781, 8933, 9255, 9549, 9753, 10417, 18898, 22494, 23139, 24764, 25989},
    {10660, 11298, 12550, 12957, 13322, 13624, 14040, 15004, 15534, 20714, 21789, 23443, 24861},
    {10522, 11530, 12552, 12963, 13378, 13779, 14245, 15235, 15902, 20102, 22696, 23774, 25838},
    {10099, 10691, 12639, 13049, 13386, 13665, 14125, 15163, 15636, 19676, 20474, 23519, 25208},
    {3144, 5087, 7382, 7504, 7593, 7690, 7801, 8064, 8232, 9248, 9875, 10521, 29048}};

static const uint16_t kAngleDelta[8][6] = {
    {2180, 5032, 7567, 22776, 26989, 30217}, {2301, 5608, 8801, 23487, 26974, 30330},
    {3780, 11018, 13699, 19354, 23083, 31286}, {4581, 11226, 15147, 17138, 21834, 28397},
    {1737, 10927, 14509, 19588, 22745, 28823}, {2664, 10176, 12485, 17650, 21600, 30495},
    {2240, 11096, 15453, 20341, 22561, 28917}, {3605, 10428, 12459, 17676, 21244, 30655}};

static const uint16_t kFilterIntra[22] = {4621, 6743, 5893, 7866, 12551, 9394, 12408, 14301,
                                          12756, 22343, 16384, 16384, 16384, 16384, 16384,
                                          16384, 12770, 10368, 20229, 18101, 16384, 16384};
static const uint16_t kFilterIntraMode[4] = {8949, 12776, 17211, 29558};

static const uint16_t kCflSign[7] = {1418, 2123, 13340, 18405, 26972, 28343, 32294};
static const uint16_t kCflAlpha[6][15] = {
    {7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708, 32712, 32716,
     32720, 32724},
    {14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620, 32647, 32668, 32672, 32676,
     32680, 32684},
    {11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673, 32677, 32681, 32685, 32689,
     32693, 32697},
    {26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708, 32712, 32716, 32720, 32724,
     32728, 32732},
    {17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394, 32464, 32516, 32560, 32576,
     32593, 32622},
    {14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144, 32413, 32520, 32594, 32622,
     32656, 32660}};

static const uint16_t kSkip[3] = {31671, 16515, 4576};
static const uint16_t kSegmentId[3][7] = {{5622, 7893, 16093, 18233, 27809, 28373, 32533},
                                          {14274, 18230, 22557, 24935, 29980, 30851, 32344},
                                          {27527, 28487, 28723, 28890, 32397, 32647, 32679}};

// coefficient CDFs: q context 0, TX_4X4
static const uint16_t kTxbSkip[13] = {31849, 5892, 12112, 21935, 20289, 27473, 32487,
                                      7654, 19473, 29984, 9961, 30242, 32117};
static const uint16_t kEobPt16[2][2][4] = {{{840, 1039, 1980, 4895}, {370, 671, 1883, 4471}},
                                           {{3247, 4950, 9688, 14563}, {1904, 3354, 7763, 14647}}};
static const uint16_t kEobExtra[2][9] = {
    {16961, 17223, 7621, 16384, 16384, 16384, 16384, 16384, 16384},
    {19069, 22525, 13377, 16384, 16384, 16384, 16384, 16384, 16384}};
static const uint16_t kCoeffBaseEob[2][4][2] = {
    {{17837, 29055}, {29600, 31446}, {30844, 31878}, {24926, 28948}},
    {{21365, 30026}, {30512, 32423}, {31658, 32621}, {29630, 31881}}};
static const uint16_t kCoeffBase[2][42][3] = {
    {{4034, 8930, 12727}, {18082, 29741, 31877}, {12596, 26124, 30493}, {9446, 21118, 27005},
     {6308, 15141, 21279}, {2463, 6357, 9783}, {20667, 30546, 31929}, {13043, 26123, 30134},
     {8151, 18757, 24778}, {5255, 12839, 18632}, {2820, 7206, 11161}, {8192, 16384, 24576},
     {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576},
     {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576},
     {8192, 16384, 24576}, {15736, 27553, 30604}, {11210, 23794, 28787}, {5947, 13874, 19701},
     {4215, 9323, 13891}, {2833, 6462, 10059}, {19605, 30393, 31582}, {13523, 26252, 30248},
     {8446, 18622, 24512}, {3818, 10343, 15974}, {1481, 4117, 6796}, {22649, 31302, 32190},
     {14829, 27127, 30449}, {8313, 17702, 23304}, {3022, 8301, 12786}, {1536, 4412, 7184},
     {22354, 29774, 31372}, {14723, 25472, 29214}, {6673, 13745, 18662}, {2068, 5766, 9322},
     {8192, 16384, 24576}, {8192, 16384, 24576}},
    {{6302, 16444, 21761}, {23040, 31538, 32475}, {15196, 28452, 31496}, {10020, 22946, 28514},
     {6533, 16862, 23501}, {3538, 9816, 15076}, {24444, 31875, 32525}, {15881, 28924, 31635},
     {9922, 22873, 28466}, {6527, 16966, 23691}, {4114, 11303, 17220}, {8192, 16384, 24576},
     {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576},
     {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576}, {8192, 16384, 24576},
     {8192, 16384, 24576}, {20201, 30770, 32209}, {14754, 28071, 31258}, {8378, 20186, 26517},
     {5916, 15299, 21978}, {4268, 11583, 17901}, {24361, 32025, 32581}, {18673, 30105, 31943},
     {10196, 22244, 27576}, {5495, 14349, 20417}, {2676, 7415, 11498}, {24678, 31958, 32585},
     {18629, 29906, 31831}, {9364, 20724, 26315}, {4641, 12318, 18094}, {2758, 7387, 11579},
     {25433, 31842, 32469}, {18795, 29289, 31411}, {7644, 17584, 23592}, {3408, 9014, 15047},
     {8192, 16384, 24576}, {8192, 16384, 24576}}};
static const uint16_t kCoeffBr[2][21][3] = {
    {{14298, 20718, 24174}, {12536, 19601, 23789}, {8712, 15051, 19503}, {6170, 11327, 15434},
     {4742, 8926, 12538}, {3803, 7317, 10546}, {1696, 3317, 4871}, {14392, 19951, 22756},
     {15978, 23218, 26818}, {12187, 19474, 23889}, {9176, 15640, 20259}, {7068, 12655, 17028},
     {5656, 10442, 14472}, {2580, 4992, 7244}, {12136, 18049, 21426}, {13784, 20721, 24481},
     {10836, 17621, 21900}, {8372, 14444, 18847}, {6523, 11779, 16000}, {5337, 9898, 13760},
     {3034, 5860, 8462}},
    {{15967, 22905, 26286}, {13534, 20654, 24579}, {9504, 16092, 20535}, {6975, 12568, 16903},
     {5364, 10091, 14020}, {4357, 8370, 11857}, {2506, 4934, 7218}, {23032, 28815, 30936},
     {19540, 26704, 29719}, {15158, 22969, 27097}, {11408, 18865, 23650}, {8885, 15448, 20250},
     {7108, 12853, 17416}, {4231, 8041, 11480}, {19823, 26490, 29156}, {18890, 25929, 28932},
     {15660, 23491, 27433}, {12147, 19776, 24488}, {9728, 16774, 21649}, {7919, 14277, 19066},
     {5440, 10170, 14185}}};
static const uint16_t kDcSign[2][3] = {{128 * 125, 128 * 102, 128 * 147},
                                       {128 * 119, 128 * 101, 128 * 135}};

// the specification's other tables
static const int8_t kFilterTaps[5][8][7] = {
    {{-6, 10, 0, 0, 0, 12, 0}, {-5, 2, 10, 0, 0, 9, 0}, {-3, 1, 1, 10, 0, 7, 0},
     {-3, 1, 1, 2, 10, 5, 0}, {-4, 6, 0, 0, 0, 2, 12}, {-3, 2, 6, 0, 0, 2, 9},
     {-3, 2, 2, 6, 0, 2, 7}, {-3, 1, 2, 2, 6, 3, 5}},
    {{-10, 16, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 6, 0}, {-4, 0, 0, 16, 0, 4, 0},
     {-2, 0, 0, 0, 16, 2, 0}, {-10, 16, 0, 0, 0, 0, 10}, {-6, 0, 16, 0, 0, 0, 6},
     {-4, 0, 0, 16, 0, 0, 4}, {-2, 0, 0, 0, 16, 0, 2}},
    {{-8, 8, 0, 0, 0, 16, 0}, {-8, 0, 8, 0, 0, 16, 0}, {-8, 0, 0, 8, 0, 16, 0},
     {-8, 0, 0, 0, 8, 16, 0}, {-4, 4, 0, 0, 0, 0, 16}, {-4, 0, 4, 0, 0, 0, 16},
     {-4, 0, 0, 4, 0, 0, 16}, {-4, 0, 0, 0, 4, 0, 16}},
    {{-2, 8, 0, 0, 0, 10, 0}, {-1, 3, 8, 0, 0, 6, 0}, {-1, 2, 3, 8, 0, 4, 0},
     {0, 1, 2, 3, 8, 2, 0}, {-1, 4, 0, 0, 0, 3, 10}, {-1, 3, 4, 0, 0, 4, 6},
     {-1, 2, 3, 4, 0, 4, 4}, {-1, 2, 2, 3, 4, 3, 3}},
    {{-12, 14, 0, 0, 0, 14, 0}, {-10, 0, 14, 0, 0, 12, 0}, {-9, 0, 0, 14, 0, 11, 0},
     {-8, 0, 0, 0, 14, 10, 0}, {-10, 12, 0, 0, 0, 0, 14}, {-9, 1, 12, 0, 0, 0, 12},
     {-8, 0, 0, 12, 0, 1, 11}, {-7, 0, 0, 1, 12, 1, 9}}};

static int dr_intra_derivative(int angle) {
  switch (angle) {
    case 3: return 1023; case 6: return 547; case 9: return 372; case 14: return 273;
    case 17: return 215; case 20: return 178; case 23: return 151; case 26: return 132;
    case 29: return 116; case 32: return 102; case 36: return 90; case 39: return 80;
    case 42: return 71; case 45: return 64; case 48: return 57; case 51: return 51;
    case 54: return 45; case 58: return 40; case 61: return 35; case 64: return 31;
    case 67: return 27; case 70: return 23; case 73: return 19; case 76: return 15;
    case 81: return 11; case 84: return 7; case 87: return 3;
    default: return 0;
  }
}

static const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
static const int kSmWeights4[4] = {255, 149, 85, 64};
static const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
static const int kEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
static const int kDefaultScan4x4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const int kCoeffBaseCtxOffset4x4[4][4] = {
    {0, 1, 6, 6}, {1, 6, 6, 21}, {6, 6, 21, 21}, {6, 21, 21, 21}};
static const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
static const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
static const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};

// block sizes, in the specification's order: BLOCK_4X4 .. BLOCK_64X16
static const int kBw4[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
static const int kBh4[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
enum { BLOCK_4X4 = 0, BLOCK_8X8 = 3, BLOCK_64X64 = 12, BLOCK_128X128 = 15, BLOCK_INVALID = 22 };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
       PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { DC_PRED = 0, V_PRED = 1, D67_PRED = 8, SMOOTH_PRED = 9, SMOOTH_V_PRED = 10,
       SMOOTH_H_PRED = 11, PAETH_PRED = 12, UV_CFL_PRED = 13 };

// refusals and faults, as av1_probe and av1_decode return them
enum {
  kOk = 0, kCorrupt = -1, kLossy = -2, kScreenContent = -3, kSuperres = -4, kFilmGrain = -5,
  kHighBitDepth = -6, kInter = -7, kTooLarge = -8
};

static int log2_of(int n) { return 31 - __builtin_clz(unsigned(n)); }  // FloorLog2, n > 0

static int block_of(int w4, int h4) {
  for (int b = 0; b < 22; b++)
    if (kBw4[b] == w4 && kBh4[b] == h4) return b;
  return BLOCK_INVALID;
}

// Subsampled_Size: a block's size in a plane subsampled by (ssx, ssy)
static int subsampled_size(int b, int ssx, int ssy) {
  if (b >= BLOCK_INVALID) return BLOCK_INVALID;
  int w4 = kBw4[b], h4 = kBh4[b];
  if ((ssx && !ssy && h4 > w4) || (!ssx && ssy && w4 > h4)) return BLOCK_INVALID;
  return block_of(std::max(1, w4 >> ssx), std::max(1, h4 >> ssy));
}

static int partition_subsize(int p, int b) {
  int n4 = kBw4[b];
  switch (p) {
    case PARTITION_NONE: return b;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B:
      return block_of(n4, n4 / 2);
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B:
      return block_of(n4 / 2, n4);
    case PARTITION_SPLIT: return block_of(n4 / 2, n4 / 2);
    case PARTITION_HORZ_4: return block_of(n4, n4 / 4);
    default: return block_of(n4 / 4, n4);
  }
}

// ---------------------------------------------------------------------------
// Bits of the headers (f(n), leb128, uvlc, su, ns, le): a read past the end
// sets ``over`` and gives zeros.
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* buf;
  int64_t size;     // bytes
  int64_t pos = 0;  // bits
  bool over = false;
  BitReader(const uint8_t* b, int64_t n) : buf(b), size(n) {}
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) {
      int bit = 0;
      if ((pos >> 3) < size) bit = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
      else over = true;
      x = (x << 1) | bit;
      pos++;
    }
    return x;
  }
  uint64_t leb128() {
    uint64_t value = 0;
    for (int i = 0; i < 8; i++) {
      uint32_t byte = f(8);
      value |= uint64_t(byte & 0x7f) << (i * 7);
      if (!(byte & 0x80)) break;
    }
    return value;
  }
  uint32_t uvlc() {
    int leading = 0;
    while (!f(1)) {
      if (over || ++leading >= 32) { over = true; return 0; }
    }
    return leading ? f(leading) + ((1u << leading) - 1) : 0;
  }
  int su(int n) {
    int value = int(f(n));
    int sign = 1 << (n - 1);
    return (value & sign) ? value - 2 * sign : value;
  }
  uint32_t ns(uint32_t n) {
    int w = 0;
    uint32_t x = n;
    while (x) { w++; x >>= 1; }
    uint32_t m = (1u << w) - n;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint64_t le(int n) {
    uint64_t t = 0;
    for (int i = 0; i < n; i++) t += uint64_t(f(8)) << (i * 8);
    return t;
  }
  void byte_alignment() { pos = (pos + 7) & ~int64_t(7); }
};

// ---------------------------------------------------------------------------
// The symbol decoder (init_symbol, read_symbol with CDF adaptation,
// read_bool, read_literal, exit_symbol). Past the tile's end it reads zero
// bits, as the specification's does.
// ---------------------------------------------------------------------------
struct SymbolDecoder {
  const uint8_t* buf = nullptr;
  int64_t size = 0, pos = 0, maxBits = 0;
  uint32_t value = 0, range = 0;
  bool adapt = true;

  // n <= 15 bits from a 24-bit window; never past the tile (numBits is
  // bounded by SymbolMaxBits), the window's bytes past it read as zeros
  uint32_t bits(int n) {
    if (n == 0) return 0;
    int64_t at = pos >> 3;
    uint32_t w = 0;
    for (int i = 0; i < 3; i++) w = (w << 8) | (at + i < size ? buf[at + i] : 0u);
    uint32_t x = (w >> (24 - int(pos & 7) - n)) & ((1u << n) - 1);
    pos += n;
    return x;
  }
  void init(const uint8_t* b, int64_t sz, bool disable_update) {
    buf = b;
    size = sz;
    pos = 0;
    int numBits = int(std::min<int64_t>(sz * 8, 15));
    uint32_t padded = bits(numBits) << (15 - numBits);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    maxBits = 8 * sz - 15;
    adapt = !disable_update;
  }
  int read(uint16_t* cdf, int N) {
    uint32_t cur = range, prev;
    int symbol = -1;
    do {
      symbol++;
      prev = cur;
      uint32_t f = (1u << 15) - cdf[symbol];
      cur = (((range >> 8) * (f >> 6)) >> 1) + 4 * uint32_t(N - symbol - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    int b = 15 - log2_of(int(range));
    range <<= b;
    int numBits = int(std::min<int64_t>(b, std::max<int64_t>(0, maxBits)));
    uint32_t padded = bits(numBits) << (b - numBits);
    value = padded ^ (((value + 1) << b) - 1);
    maxBits -= b;
    if (adapt) {
      int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(log2_of(N), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < N - 1; i++) {
        if (i == symbol) tmp = 1u << 15;
        if (tmp < cdf[i]) cdf[i] -= uint16_t((cdf[i] - tmp) >> rate);
        else cdf[i] += uint16_t((tmp - cdf[i]) >> rate);
      }
      cdf[N] += (cdf[N] < 32);
    }
    return symbol;
  }
  int read_bool() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    bool keep = adapt;
    adapt = false;
    int b = read(cdf, 2);
    adapt = keep;
    return b;
  }
  int read_literal(int n) {
    int x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + read_bool();
    return x;
  }
  // exit_symbol's padding: the bit at trailingBitPosition is 1 and every
  // later bit of the tile 0. A check of the stream, never a refusal.
  bool padding_ok() const {
    int64_t trailing = 8 * size - 15 - maxBits;
    if (trailing < 0 || trailing >= 8 * size) return false;
    for (int64_t p = trailing; p < 8 * size; p++) {
      int bit = (buf[p >> 3] >> (7 - (p & 7))) & 1;
      if (bit != (p == trailing)) return false;
    }
    return true;
  }
};

// the CDFs an intra frame reads, each row followed by 32768 and its counter
struct Cdfs {
  uint16_t partW8[4][5], partW16[4][11], partW32[4][11], partW64[4][11], partW128[4][9];
  uint16_t kfYMode[5][5][14];
  uint16_t uvNoCfl[13][14], uvCfl[13][15];
  uint16_t angleDelta[8][8];
  uint16_t filterIntra[22][3], filterIntraMode[6];
  uint16_t cflSign[9], cflAlpha[6][17];
  uint16_t skip[3][3];
  uint16_t segId[3][9];
  uint16_t txbSkip[13][3];
  uint16_t eobPt16[2][2][6];
  uint16_t eobExtra[2][9][3];
  uint16_t baseEob[2][4][4];
  uint16_t base[2][42][5];
  uint16_t br[2][21][5];
  uint16_t dcSign[2][3][3];
};

static void fill(uint16_t* dst, const uint16_t* src, int rows, int n) {
  for (int r = 0; r < rows; r++) {
    for (int i = 0; i < n - 1; i++) dst[r * (n + 1) + i] = src[r * (n - 1) + i];
    dst[r * (n + 1) + n - 1] = 32768;
    dst[r * (n + 1) + n] = 0;
  }
}

static void default_cdfs(Cdfs& c) {
  fill(&c.partW8[0][0], &kPartitionW8[0][0], 4, 4);
  fill(&c.partW16[0][0], &kPartitionW16[0][0], 4, 10);
  fill(&c.partW32[0][0], &kPartitionW32[0][0], 4, 10);
  fill(&c.partW64[0][0], &kPartitionW64[0][0], 4, 10);
  fill(&c.partW128[0][0], &kPartitionW128[0][0], 4, 8);
  fill(&c.kfYMode[0][0][0], &kKfYMode[0][0][0], 25, 13);
  fill(&c.uvNoCfl[0][0], &kUvModeNoCfl[0][0], 13, 13);
  fill(&c.uvCfl[0][0], &kUvModeCfl[0][0], 13, 14);
  fill(&c.angleDelta[0][0], &kAngleDelta[0][0], 8, 7);
  fill(&c.filterIntra[0][0], kFilterIntra, 22, 2);
  fill(c.filterIntraMode, kFilterIntraMode, 1, 5);
  fill(c.cflSign, kCflSign, 1, 8);
  fill(&c.cflAlpha[0][0], &kCflAlpha[0][0], 6, 16);
  fill(&c.skip[0][0], kSkip, 3, 2);
  fill(&c.segId[0][0], &kSegmentId[0][0], 3, 8);
  fill(&c.txbSkip[0][0], kTxbSkip, 13, 2);
  fill(&c.eobPt16[0][0][0], &kEobPt16[0][0][0], 4, 5);
  fill(&c.eobExtra[0][0][0], &kEobExtra[0][0], 18, 2);
  fill(&c.baseEob[0][0][0], &kCoeffBaseEob[0][0][0], 8, 3);
  fill(&c.base[0][0][0], &kCoeffBase[0][0][0], 84, 4);
  fill(&c.br[0][0][0], &kCoeffBr[0][0][0], 42, 4);
  fill(&c.dcSign[0][0][0], &kDcSign[0][0], 6, 2);
}

// ---------------------------------------------------------------------------
// The decoder: the sequence header, the first shown frame's header, its tile
// groups, and every tile of a coded-lossless key frame.
// ---------------------------------------------------------------------------
struct Decoder {
  // sequence header
  bool haveSeq = false;
  int seq_profile = 0, still_picture = 0, reduced_still_picture_header = 0;
  int timing_info_present_flag = 0, decoder_model_info_present_flag = 0;
  int equal_picture_interval = 0, buffer_delay_length_minus_1 = 0;
  int buffer_removal_time_length_minus_1 = 0;
  int frame_presentation_time_length_minus_1 = 0, operating_points_cnt_minus_1 = 0;
  int operating_point_idc[32] = {0}, decoder_model_present_for_this_op[32] = {0};
  int frame_width_bits_minus_1 = 0, frame_height_bits_minus_1 = 0;
  int max_frame_width_minus_1 = 0, max_frame_height_minus_1 = 0;
  int frame_id_numbers_present_flag = 0, delta_frame_id_length_minus_2 = 0;
  int additional_frame_id_length_minus_1 = 0;
  int use_128x128_superblock = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
  int enable_order_hint = 0, OrderHintBits = 0;
  int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
  int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
  int BitDepth = 8, mono_chrome = 0, NumPlanes = 3;
  int color_primaries = 2, transfer_characteristics = 2, matrix_coefficients = 2;
  int color_range = 0, subsampling_x = 1, subsampling_y = 1, chroma_sample_position = 0;
  int separate_uv_delta_q = 0, film_grain_params_present = 0;

  // frame header
  bool haveFrame = false;
  int temporal_id = 0, spatial_id = 0;
  int show_frame = 1, showable_frame = 0, frame_type = 0, error_resilient_mode = 1;
  int disable_cdf_update = 0, allow_screen_content_tools = 0, allow_intrabc = 0;
  int FrameWidth = 0, FrameHeight = 0, MiCols = 0, MiRows = 0;
  int TileCols = 1, TileRows = 1, TileColsLog2 = 0, TileRowsLog2 = 0, TileSizeBytes = 4;
  int uniform_tile_spacing_flag = 1;
  int context_update_tile_id = 0;
  int MiColStarts[65] = {0}, MiRowStarts[65] = {0};
  int base_q_idx = 0, DeltaQYDc = 0, DeltaQUDc = 0, DeltaQUAc = 0, DeltaQVDc = 0, DeltaQVAc = 0;
  int using_qmatrix = 0, delta_q_present = 0, reduced_tx_set = 0;
  int segmentation_enabled = 0, FeatureEnabled[8][8] = {{0}}, FeatureData[8][8] = {{0}};
  int SegIdPreSkip = 0, LastActiveSegId = 0, LosslessArray[8] = {0};

  // frame state
  std::vector<uint8_t> planes[3];
  int pstride[3] = {0}, pheight[3] = {0};
  int miStride = 0;
  std::vector<uint8_t> MiSizes, YModes, UVModes, Skips, SegmentIds;
  std::vector<uint8_t> AboveLevel[3], AboveDc[3], LeftLevel[3], LeftDc[3];
  uint8_t BlockDecoded[3][34][34];
  Cdfs cdf;
  SymbolDecoder sd;
  bool fault = false;
  int tilesDone = 0;
  std::vector<int> tilePadding;

  // tile and block state
  int MiRowStart = 0, MiRowEnd = 0, MiColStart = 0, MiColEnd = 0;
  int MiRow = 0, MiCol = 0, MiSize = 0, HasChroma = 0;
  int AvailU = 0, AvailL = 0, AvailUChroma = 0, AvailLChroma = 0;
  int skip = 0, segment_id = 0, Lossless = 1, YMode = 0, UVMode = 0;
  int AngleDeltaY = 0, AngleDeltaUV = 0, use_filter_intra = 0, filter_intra_mode = 0;
  int CflAlphaU = 0, CflAlphaV = 0, MaxLumaW = 0, MaxLumaH = 0;
  int Quant[16];
  int Near[6][6];   // Min(level, 3) of the block's coefficients, zero beyond the 4 x 4

  uint8_t& mi(std::vector<uint8_t>& a, int r, int c) { return a[size_t(r) * miStride + c]; }
  uint8_t& px(int plane, int y, int x) { return planes[plane][size_t(y) * pstride[plane] + x]; }
  uint8_t& bd(int plane, int y, int x) { return BlockDecoded[plane][y + 1][x + 1]; }

  // --- sequence header (5.5) ---
  int sequence_header(BitReader& br) {
    seq_profile = int(br.f(3));
    still_picture = int(br.f(1));
    reduced_still_picture_header = int(br.f(1));
    if (reduced_still_picture_header) {
      operating_point_idc[0] = 0;
      br.f(5);  // seq_level_idx[0]
    } else {
      timing_info_present_flag = int(br.f(1));
      if (timing_info_present_flag) {
        br.f(32);  // num_units_in_display_tick
        br.f(32);  // time_scale
        equal_picture_interval = int(br.f(1));
        if (equal_picture_interval) br.uvlc();
        decoder_model_info_present_flag = int(br.f(1));
        if (decoder_model_info_present_flag) {
          buffer_delay_length_minus_1 = int(br.f(5));
          br.f(32);  // num_units_in_decoding_tick
          buffer_removal_time_length_minus_1 = int(br.f(5));
          frame_presentation_time_length_minus_1 = int(br.f(5));
        }
      }
      int initial_display_delay_present_flag = int(br.f(1));
      operating_points_cnt_minus_1 = int(br.f(5));
      for (int i = 0; i <= operating_points_cnt_minus_1; i++) {
        operating_point_idc[i] = int(br.f(12));
        int seq_level_idx = int(br.f(5));
        if (seq_level_idx > 7) br.f(1);  // seq_tier
        if (decoder_model_info_present_flag) {
          decoder_model_present_for_this_op[i] = int(br.f(1));
          if (decoder_model_present_for_this_op[i]) {  // operating_parameters_info
            br.f(buffer_delay_length_minus_1 + 1);      // decoder_buffer_delay
            br.f(buffer_delay_length_minus_1 + 1);      // encoder_buffer_delay
            br.f(1);                                    // low_delay_mode_flag
          }
        }
        if (initial_display_delay_present_flag)
          if (br.f(1)) br.f(4);
      }
    }
    frame_width_bits_minus_1 = int(br.f(4));
    frame_height_bits_minus_1 = int(br.f(4));
    max_frame_width_minus_1 = int(br.f(frame_width_bits_minus_1 + 1));
    max_frame_height_minus_1 = int(br.f(frame_height_bits_minus_1 + 1));
    frame_id_numbers_present_flag = reduced_still_picture_header ? 0 : int(br.f(1));
    if (frame_id_numbers_present_flag) {
      delta_frame_id_length_minus_2 = int(br.f(4));
      additional_frame_id_length_minus_1 = int(br.f(3));
    }
    use_128x128_superblock = int(br.f(1));
    enable_filter_intra = int(br.f(1));
    enable_intra_edge_filter = int(br.f(1));
    if (reduced_still_picture_header) {
      seq_force_screen_content_tools = 2;
      seq_force_integer_mv = 2;
      OrderHintBits = 0;
    } else {
      br.f(1);  // enable_interintra_compound
      br.f(1);  // enable_masked_compound
      br.f(1);  // enable_warped_motion
      br.f(1);  // enable_dual_filter
      enable_order_hint = int(br.f(1));
      if (enable_order_hint) {
        br.f(1);  // enable_jnt_comp
        br.f(1);  // enable_ref_frame_mvs
      }
      int seq_choose_screen_content_tools = int(br.f(1));
      seq_force_screen_content_tools = seq_choose_screen_content_tools ? 2 : int(br.f(1));
      if (seq_force_screen_content_tools > 0) {
        int seq_choose_integer_mv = int(br.f(1));
        seq_force_integer_mv = seq_choose_integer_mv ? 2 : int(br.f(1));
      } else {
        seq_force_integer_mv = 2;
      }
      OrderHintBits = enable_order_hint ? int(br.f(3)) + 1 : 0;
    }
    enable_superres = int(br.f(1));
    enable_cdef = int(br.f(1));
    enable_restoration = int(br.f(1));
    // color_config
    int high_bitdepth = int(br.f(1));
    if (seq_profile == 2 && high_bitdepth) BitDepth = br.f(1) ? 12 : 10;
    else BitDepth = high_bitdepth ? 10 : 8;
    mono_chrome = seq_profile == 1 ? 0 : int(br.f(1));
    NumPlanes = mono_chrome ? 1 : 3;
    if (br.f(1)) {
      color_primaries = int(br.f(8));
      transfer_characteristics = int(br.f(8));
      matrix_coefficients = int(br.f(8));
    } else {
      color_primaries = transfer_characteristics = matrix_coefficients = 2;
    }
    if (mono_chrome) {
      color_range = int(br.f(1));
      subsampling_x = subsampling_y = 1;
      chroma_sample_position = 0;
      separate_uv_delta_q = 0;
    } else {
      if (color_primaries == 1 && transfer_characteristics == 13 && matrix_coefficients == 0) {
        color_range = 1;
        subsampling_x = subsampling_y = 0;
      } else {
        color_range = int(br.f(1));
        if (seq_profile == 0) {
          subsampling_x = subsampling_y = 1;
        } else if (seq_profile == 1) {
          subsampling_x = subsampling_y = 0;
        } else if (BitDepth == 12) {
          subsampling_x = int(br.f(1));
          subsampling_y = subsampling_x ? int(br.f(1)) : 0;
        } else {
          subsampling_x = 1;
          subsampling_y = 0;
        }
        if (subsampling_x && subsampling_y) chroma_sample_position = int(br.f(2));
      }
      separate_uv_delta_q = int(br.f(1));
    }
    film_grain_params_present = int(br.f(1));
    if (br.over) return kCorrupt;
    haveSeq = true;
    return kOk;
  }

  int read_delta_q(BitReader& br) { return br.f(1) ? br.su(7) : 0; }

  static int tile_log2(int blkSize, int target) {
    int k = 0;
    while ((blkSize << k) < target) k++;
    return k;
  }

  int tile_info(BitReader& br) {
    int sbCols = use_128x128_superblock ? ((MiCols + 31) >> 5) : ((MiCols + 15) >> 4);
    int sbRows = use_128x128_superblock ? ((MiRows + 31) >> 5) : ((MiRows + 15) >> 4);
    int sbShift = use_128x128_superblock ? 5 : 4;
    int sbSize = sbShift + 2;
    int maxTileWidthSb = 4096 >> sbSize;
    int maxTileAreaSb = (4096 * 2304) >> (2 * sbSize);
    int minLog2TileCols = tile_log2(maxTileWidthSb, sbCols);
    int maxLog2TileCols = tile_log2(1, std::min(sbCols, 64));
    int maxLog2TileRows = tile_log2(1, std::min(sbRows, 64));
    int minLog2Tiles = std::max(minLog2TileCols, tile_log2(maxTileAreaSb, sbRows * sbCols));
    uniform_tile_spacing_flag = int(br.f(1));
    if (uniform_tile_spacing_flag) {
      TileColsLog2 = minLog2TileCols;
      while (TileColsLog2 < maxLog2TileCols && br.f(1)) TileColsLog2++;
      int tileWidthSb = (sbCols + (1 << TileColsLog2) - 1) >> TileColsLog2;
      int i = 0;
      for (int startSb = 0; startSb < sbCols; startSb += tileWidthSb) {
        if (i >= 64) return kCorrupt;
        MiColStarts[i++] = startSb << sbShift;
      }
      MiColStarts[i] = MiCols;
      TileCols = i;
      int minLog2TileRows = std::max(minLog2Tiles - TileColsLog2, 0);
      TileRowsLog2 = minLog2TileRows;
      while (TileRowsLog2 < maxLog2TileRows && br.f(1)) TileRowsLog2++;
      int tileHeightSb = (sbRows + (1 << TileRowsLog2) - 1) >> TileRowsLog2;
      i = 0;
      for (int startSb = 0; startSb < sbRows; startSb += tileHeightSb) {
        if (i >= 64) return kCorrupt;
        MiRowStarts[i++] = startSb << sbShift;
      }
      MiRowStarts[i] = MiRows;
      TileRows = i;
    } else {
      int widestTileSb = 0, startSb = 0, i;
      for (i = 0; startSb < sbCols; i++) {
        if (i >= 64 || br.over) return kCorrupt;
        MiColStarts[i] = startSb << sbShift;
        int maxWidth = std::min(sbCols - startSb, maxTileWidthSb);
        int sizeSb = int(br.ns(uint32_t(maxWidth))) + 1;
        widestTileSb = std::max(sizeSb, widestTileSb);
        startSb += sizeSb;
      }
      MiColStarts[i] = MiCols;
      TileCols = i;
      TileColsLog2 = tile_log2(1, TileCols);
      if (minLog2Tiles > 0) maxTileAreaSb = (sbRows * sbCols) >> (minLog2Tiles + 1);
      else maxTileAreaSb = sbRows * sbCols;
      int maxTileHeightSb = std::max(maxTileAreaSb / widestTileSb, 1);
      startSb = 0;
      for (i = 0; startSb < sbRows; i++) {
        if (i >= 64 || br.over) return kCorrupt;
        MiRowStarts[i] = startSb << sbShift;
        int maxHeight = std::min(sbRows - startSb, maxTileHeightSb);
        startSb += int(br.ns(uint32_t(maxHeight))) + 1;
      }
      MiRowStarts[i] = MiRows;
      TileRows = i;
      TileRowsLog2 = tile_log2(1, TileRows);
    }
    for (int i = 0; i < TileCols; i++)
      if (MiColStarts[i] >= MiColStarts[i + 1]) return kCorrupt;
    for (int i = 0; i < TileRows; i++)
      if (MiRowStarts[i] >= MiRowStarts[i + 1]) return kCorrupt;
    if (TileColsLog2 > 0 || TileRowsLog2 > 0) {
      context_update_tile_id = int(br.f(TileRowsLog2 + TileColsLog2));
      TileSizeBytes = int(br.f(2)) + 1;
    } else {
      context_update_tile_id = 0;
    }
    return kOk;
  }

  int get_qidx(int segmentId) {
    if (segmentation_enabled && FeatureEnabled[segmentId][0])
      return std::min(255, std::max(0, base_q_idx + FeatureData[segmentId][0]));
    return base_q_idx;
  }

  // --- uncompressed_header (5.9) of the first shown frame ---
  int frame_header(BitReader& br) {
    if (!haveSeq) return kCorrupt;
    int idLen = frame_id_numbers_present_flag
                    ? additional_frame_id_length_minus_1 + delta_frame_id_length_minus_2 + 3
                    : 0;
    if (reduced_still_picture_header) {
      frame_type = 0;
      show_frame = 1;
      showable_frame = 0;
      error_resilient_mode = 1;
    } else {
      if (br.f(1)) return kInter;  // show_existing_frame
      frame_type = int(br.f(2));
      show_frame = int(br.f(1));
      if (frame_type != 0 || !show_frame) return kInter;
      if (decoder_model_info_present_flag && !equal_picture_interval)
        br.f(frame_presentation_time_length_minus_1 + 1);
      showable_frame = 0;
      error_resilient_mode = 1;
    }
    disable_cdf_update = int(br.f(1));
    allow_screen_content_tools = seq_force_screen_content_tools == 2
                                     ? int(br.f(1)) : seq_force_screen_content_tools;
    if (allow_screen_content_tools) {
      if (seq_force_integer_mv == 2) br.f(1);  // force_integer_mv
    }
    if (frame_id_numbers_present_flag) br.f(idLen);  // current_frame_id
    int frame_size_override_flag = reduced_still_picture_header ? 0 : int(br.f(1));
    br.f(OrderHintBits);  // order_hint
    // primary_ref_frame is PRIMARY_REF_NONE for an intra frame
    if (decoder_model_info_present_flag) {
      if (br.f(1)) {  // buffer_removal_time_present_flag
        for (int op = 0; op <= operating_points_cnt_minus_1; op++) {
          if (decoder_model_present_for_this_op[op]) {
            int idc = operating_point_idc[op];
            int inT = (idc >> temporal_id) & 1, inS = (idc >> (spatial_id + 8)) & 1;
            if (idc == 0 || (inT && inS)) br.f(buffer_removal_time_length_minus_1 + 1);
          }
        }
      }
    }
    // refresh_frame_flags is allFrames for a shown key frame
    // frame_size
    if (frame_size_override_flag) {
      FrameWidth = int(br.f(frame_width_bits_minus_1 + 1)) + 1;
      FrameHeight = int(br.f(frame_height_bits_minus_1 + 1)) + 1;
    } else {
      FrameWidth = max_frame_width_minus_1 + 1;
      FrameHeight = max_frame_height_minus_1 + 1;
    }
    if (enable_superres && br.f(1)) return kSuperres;  // use_superres
    if (FrameWidth > 32768 || FrameHeight > 32768 ||
        int64_t(FrameWidth) * FrameHeight > int64_t(16384) * 16384)
      return kTooLarge;
    MiCols = 2 * ((FrameWidth + 7) >> 3);
    MiRows = 2 * ((FrameHeight + 7) >> 3);
    if (br.f(1)) br.f(32);  // render_and_frame_size_different, render size
    if (allow_screen_content_tools) return kScreenContent;  // palette and intrabc
    // disable_frame_end_update_cdf (no later frame reads it)
    if (!reduced_still_picture_header && !disable_cdf_update) br.f(1);
    int r = tile_info(br);
    if (r) return r;
    // quantization_params
    base_q_idx = int(br.f(8));
    DeltaQYDc = read_delta_q(br);
    if (NumPlanes > 1) {
      int diff_uv_delta = separate_uv_delta_q ? int(br.f(1)) : 0;
      DeltaQUDc = read_delta_q(br);
      DeltaQUAc = read_delta_q(br);
      if (diff_uv_delta) {
        DeltaQVDc = read_delta_q(br);
        DeltaQVAc = read_delta_q(br);
      } else {
        DeltaQVDc = DeltaQUDc;
        DeltaQVAc = DeltaQUAc;
      }
    }
    using_qmatrix = int(br.f(1));
    if (using_qmatrix) {
      br.f(4);
      br.f(4);
      if (separate_uv_delta_q) br.f(4);
    }
    // segmentation_params (primary_ref_frame is none: the data is updated)
    segmentation_enabled = int(br.f(1));
    if (segmentation_enabled) {
      for (int i = 0; i < 8; i++) {
        for (int j = 0; j < 8; j++) {
          int value = 0;
          FeatureEnabled[i][j] = int(br.f(1));
          if (FeatureEnabled[i][j]) {
            int bits = kSegFeatureBits[j], limit = kSegFeatureMax[j];
            if (kSegFeatureSigned[j]) value = std::min(limit, std::max(-limit, br.su(1 + bits)));
            else value = std::min(limit, int(br.f(bits)));
          }
          FeatureData[i][j] = value;
        }
      }
    }
    SegIdPreSkip = 0;
    LastActiveSegId = 0;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (FeatureEnabled[i][j]) {
          LastActiveSegId = i;
          if (j >= 5) SegIdPreSkip = 1;
        }
    // delta_q_params, delta_lf_params
    delta_q_present = base_q_idx > 0 ? int(br.f(1)) : 0;
    // CodedLossless
    bool coded_lossless = true;
    for (int s = 0; s < 8; s++) {
      LosslessArray[s] = get_qidx(s) == 0 && !DeltaQYDc && !DeltaQUAc && !DeltaQUDc &&
                         !DeltaQVAc && !DeltaQVDc;
      if (!LosslessArray[s]) coded_lossless = false;
    }
    if (!coded_lossless || delta_q_present) return kLossy;
    // loop_filter_params, cdef_params, lr_params: none under CodedLossless;
    // read_tx_mode: ONLY_4X4; frame_reference_mode, skip_mode_params,
    // allow_warped_motion and global_motion_params: nothing in an intra frame
    reduced_tx_set = int(br.f(1));
    // film_grain_params
    if (film_grain_params_present && (show_frame || showable_frame)) {
      if (br.f(1)) return kFilmGrain;  // apply_grain
    }
    if (br.over) return kCorrupt;
    haveFrame = true;
    return kOk;
  }

  // --- the frame's buffers ---
  void alloc_frame() {
    miStride = MiCols + 64;
    size_t n = size_t(miStride) * (MiRows + 64);
    MiSizes.assign(n, 0);
    YModes.assign(n, 0);
    UVModes.assign(n, 0);
    Skips.assign(n, 0);
    SegmentIds.assign(n, 0);
    for (int p = 0; p < NumPlanes; p++) {
      int sx = p ? subsampling_x : 0, sy = p ? subsampling_y : 0;
      pstride[p] = ((MiCols * 4) >> sx) + 16;
      pheight[p] = ((MiRows * 4) >> sy) + 16;
      planes[p].assign(size_t(pstride[p]) * pheight[p], 0);
      AboveLevel[p].assign(MiCols + 64, 0);
      AboveDc[p].assign(MiCols + 64, 0);
      LeftLevel[p].assign(MiRows + 64, 0);
      LeftDc[p].assign(MiRows + 64, 0);
    }
  }

  bool is_inside(int r, int c) const {
    return c >= MiColStart && c < MiColEnd && r >= MiRowStart && r < MiRowEnd;
  }

  // --- decode_tile and the partition tree ---
  void decode_tile() {
    for (int p = 0; p < NumPlanes; p++) {
      std::fill(AboveLevel[p].begin(), AboveLevel[p].end(), 0);
      std::fill(AboveDc[p].begin(), AboveDc[p].end(), 0);
    }
    int sbSize = use_128x128_superblock ? BLOCK_128X128 : BLOCK_64X64;
    int sbSize4 = kBw4[sbSize];
    for (int r = MiRowStart; r < MiRowEnd && !fault; r += sbSize4) {
      for (int p = 0; p < NumPlanes; p++) {
        std::fill(LeftLevel[p].begin(), LeftLevel[p].end(), 0);
        std::fill(LeftDc[p].begin(), LeftDc[p].end(), 0);
      }
      for (int c = MiColStart; c < MiColEnd && !fault; c += sbSize4) {
        clear_block_decoded_flags(r, c, sbSize4);
        decode_partition(r, c, sbSize);
      }
    }
  }

  void clear_block_decoded_flags(int r, int c, int sbSize4) {
    for (int p = 0; p < NumPlanes; p++) {
      int sx = p ? subsampling_x : 0, sy = p ? subsampling_y : 0;
      int sbWidth4 = (MiColEnd - c) >> sx, sbHeight4 = (MiRowEnd - r) >> sy;
      for (int y = -1; y <= (sbSize4 >> sy); y++)
        for (int x = -1; x <= (sbSize4 >> sx); x++)
          bd(p, y, x) = (y < 0 && x < sbWidth4) || (x < 0 && y < sbHeight4);
      bd(p, sbSize4 >> sy, -1) = 0;
    }
  }

  uint16_t* partition_cdf(int bsl, int ctx) {
    switch (bsl) {
      case 1: return cdf.partW8[ctx];
      case 2: return cdf.partW16[ctx];
      case 3: return cdf.partW32[ctx];
      case 4: return cdf.partW64[ctx];
      default: return cdf.partW128[ctx];
    }
  }

  void decode_partition(int r, int c, int bSize) {
    if (fault || r >= MiRows || c >= MiCols) return;
    int availU = is_inside(r - 1, c), availL = is_inside(r, c - 1);
    int num4x4 = kBw4[bSize], half = num4x4 >> 1, quarter = half >> 1;
    int hasRows = (r + half) < MiRows, hasCols = (c + half) < MiCols;
    int partition;
    if (bSize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int bsl = log2_of(kBw4[bSize]);
      int above = availU && log2_of(kBw4[mi(MiSizes, r - 1, c)]) < bsl;
      int left = availL && log2_of(kBh4[mi(MiSizes, r, c - 1)]) < bsl;
      int ctx = left * 2 + above;
      uint16_t* pc = partition_cdf(bsl, ctx);
      int N = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      auto prob = [&](int p) { return int(pc[p]) - (p > 0 ? int(pc[p - 1]) : 0); };
      if (hasRows && hasCols) {
        partition = sd.read(pc, N);
      } else if (hasCols) {  // split_or_horz
        // the partitions whose top half is split vertically
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                   prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
        if (bSize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        uint16_t tmp[3] = {uint16_t((1 << 15) - psum), 1 << 15, 0};
        bool keep = sd.adapt;
        sd.adapt = false;
        partition = sd.read(tmp, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
        sd.adapt = keep;
      } else if (hasRows) {  // split_or_vert
        // the partitions whose left half is split horizontally
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                   prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
        if (bSize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        uint16_t tmp[3] = {uint16_t((1 << 15) - psum), 1 << 15, 0};
        bool keep = sd.adapt;
        sd.adapt = false;
        partition = sd.read(tmp, 2) ? PARTITION_SPLIT : PARTITION_VERT;
        sd.adapt = keep;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int subSize = partition_subsize(partition, bSize);
    int splitSize = partition_subsize(PARTITION_SPLIT, bSize);
    if (subSize == BLOCK_INVALID) { fault = true; return; }
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, subSize); break;
      case PARTITION_HORZ:
        decode_block(r, c, subSize);
        if (hasRows) decode_block(r + half, c, subSize);
        break;
      case PARTITION_VERT:
        decode_block(r, c, subSize);
        if (hasCols) decode_block(r, c + half, subSize);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, subSize);
        decode_partition(r, c + half, subSize);
        decode_partition(r + half, c, subSize);
        decode_partition(r + half, c + half, subSize);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, splitSize);
        decode_block(r, c + half, splitSize);
        decode_block(r + half, c, subSize);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, subSize);
        decode_block(r + half, c, splitSize);
        decode_block(r + half, c + half, splitSize);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, splitSize);
        decode_block(r + half, c, splitSize);
        decode_block(r, c + half, subSize);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, subSize);
        decode_block(r, c + half, splitSize);
        decode_block(r + half, c + half, splitSize);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < MiRows) decode_block(r + quarter * i, c, subSize);
        break;
      default:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < MiCols) decode_block(r, c + quarter * i, subSize);
        break;
    }
  }

  // --- decode_block and intra_frame_mode_info ---
  void decode_block(int r, int c, int subSize) {
    if (fault) return;
    MiRow = r;
    MiCol = c;
    MiSize = subSize;
    int bw4 = kBw4[subSize], bh4 = kBh4[subSize];
    if (bh4 == 1 && subsampling_y && (MiRow & 1) == 0) HasChroma = 0;
    else if (bw4 == 1 && subsampling_x && (MiCol & 1) == 0) HasChroma = 0;
    else HasChroma = NumPlanes > 1;
    AvailU = is_inside(r - 1, c);
    AvailL = is_inside(r, c - 1);
    AvailUChroma = AvailU;
    AvailLChroma = AvailL;
    if (HasChroma) {
      if (subsampling_y && bh4 == 1) AvailUChroma = is_inside(r - 2, c);
      if (subsampling_x && bw4 == 1) AvailLChroma = is_inside(r, c - 2);
      if (subsampled_size(MiSize, subsampling_x, subsampling_y) == BLOCK_INVALID) {
        fault = true;
        return;
      }
    } else {
      AvailUChroma = AvailLChroma = 0;
    }
    intra_frame_mode_info();
    if (skip) reset_block_context(bw4, bh4);
    for (int y = 0; y < bh4; y++)
      for (int x = 0; x < bw4; x++) {
        mi(YModes, r + y, c + x) = uint8_t(YMode);
        if (HasChroma) mi(UVModes, r + y, c + x) = uint8_t(UVMode);
        mi(Skips, r + y, c + x) = uint8_t(skip);
        mi(MiSizes, r + y, c + x) = uint8_t(MiSize);
        mi(SegmentIds, r + y, c + x) = uint8_t(segment_id);
      }
    residual();
  }

  void reset_block_context(int bw4, int bh4) {
    for (int p = 0; p < 1 + 2 * HasChroma; p++) {
      int sx = p ? subsampling_x : 0, sy = p ? subsampling_y : 0;
      for (int i = MiCol >> sx; i < ((MiCol + bw4) >> sx); i++) AboveLevel[p][i] = AboveDc[p][i] = 0;
      for (int i = MiRow >> sy; i < ((MiRow + bh4) >> sy); i++) LeftLevel[p][i] = LeftDc[p][i] = 0;
    }
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
  }

  void intra_segment_id() {
    if (!segmentation_enabled) {
      segment_id = 0;
    } else {
      int prevUL = AvailU && AvailL ? mi(SegmentIds, MiRow - 1, MiCol - 1) : -1;
      int prevU = AvailU ? mi(SegmentIds, MiRow - 1, MiCol) : -1;
      int prevL = AvailL ? mi(SegmentIds, MiRow, MiCol - 1) : -1;
      int pred;
      if (prevU == -1) pred = prevL == -1 ? 0 : prevL;
      else if (prevL == -1) pred = prevU;
      else pred = prevUL == prevU ? prevU : prevL;
      if (skip) {
        segment_id = pred;
      } else {
        int ctx;
        if (prevUL < 0 || prevU < 0 || prevL < 0) ctx = 0;
        else if (prevUL == prevU && prevUL == prevL) ctx = 2;
        else if (prevUL == prevU || prevUL == prevL || prevU == prevL) ctx = 1;
        else ctx = 0;
        int s = sd.read(cdf.segId[ctx], 8);
        segment_id = std::min(LastActiveSegId,
                              std::max(0, neg_deinterleave(s, pred, LastActiveSegId + 1)));
      }
    }
    Lossless = LosslessArray[segment_id];
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (SegIdPreSkip) intra_segment_id();
    if (SegIdPreSkip && segmentation_enabled && FeatureEnabled[segment_id][6]) {
      skip = 1;
    } else {
      int ctx = (AvailU ? mi(Skips, MiRow - 1, MiCol) : 0) + (AvailL ? mi(Skips, MiRow, MiCol - 1) : 0);
      skip = sd.read(cdf.skip[ctx], 2);
    }
    if (!SegIdPreSkip) intra_segment_id();
    int aboveMode = AvailU ? mi(YModes, MiRow - 1, MiCol) : DC_PRED;
    int leftMode = AvailL ? mi(YModes, MiRow, MiCol - 1) : DC_PRED;
    YMode = sd.read(cdf.kfYMode[kIntraModeContext[aboveMode]][kIntraModeContext[leftMode]], 13);
    AngleDeltaY = 0;
    if (MiSize >= BLOCK_8X8 && YMode >= V_PRED && YMode <= D67_PRED)
      AngleDeltaY = sd.read(cdf.angleDelta[YMode - V_PRED], 7) - 3;
    UVMode = DC_PRED;
    AngleDeltaUV = 0;
    CflAlphaU = CflAlphaV = 0;
    if (HasChroma) {
      int cflAllowed;
      if (Lossless) cflAllowed = subsampled_size(MiSize, subsampling_x, subsampling_y) == BLOCK_4X4;
      else cflAllowed = std::max(kBw4[MiSize], kBh4[MiSize]) <= 8;
      UVMode = cflAllowed ? sd.read(cdf.uvCfl[YMode], 14) : sd.read(cdf.uvNoCfl[YMode], 13);
      if (UVMode == UV_CFL_PRED) read_cfl_alphas();
      if (MiSize >= BLOCK_8X8 && UVMode >= V_PRED && UVMode <= D67_PRED)
        AngleDeltaUV = sd.read(cdf.angleDelta[UVMode - V_PRED], 7) - 3;
    }
    use_filter_intra = 0;
    if (enable_filter_intra && YMode == DC_PRED && std::max(kBw4[MiSize], kBh4[MiSize]) <= 8) {
      use_filter_intra = sd.read(cdf.filterIntra[MiSize], 2);
      if (use_filter_intra) filter_intra_mode = sd.read(cdf.filterIntraMode, 5);
    }
  }

  void read_cfl_alphas() {
    int signs = sd.read(cdf.cflSign, 8);
    int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
    if (signU) {
      CflAlphaU = 1 + sd.read(cdf.cflAlpha[(signU - 1) * 3 + signV], 16);
      if (signU == 1) CflAlphaU = -CflAlphaU;
    }
    if (signV) {
      CflAlphaV = 1 + sd.read(cdf.cflAlpha[(signV - 1) * 3 + signU], 16);
      if (signV == 1) CflAlphaV = -CflAlphaV;
    }
  }

  // --- residual: every block is coded in 4x4 transform blocks ---
  void residual() {
    int widthChunks = std::max(1, kBw4[MiSize] >> 4), heightChunks = std::max(1, kBh4[MiSize] >> 4);
    int subBlockMiSize = (widthChunks > 1 || heightChunks > 1) ? BLOCK_64X64 : MiSize;
    for (int chunkY = 0; chunkY < heightChunks; chunkY++)
      for (int chunkX = 0; chunkX < widthChunks; chunkX++)
        for (int p = 0; p < 1 + HasChroma * 2; p++) {
          int sx = p ? subsampling_x : 0, sy = p ? subsampling_y : 0;
          int planeSz = p ? subsampled_size(subBlockMiSize, sx, sy) : subBlockMiSize;
          int num4x4W = kBw4[planeSz], num4x4H = kBh4[planeSz];
          int baseX = (MiCol >> sx) * 4, baseY = (MiRow >> sy) * 4;
          for (int y = 0; y < num4x4H; y++)
            for (int x = 0; x < num4x4W; x++)
              transform_block(p, baseX, baseY, x + ((chunkX << 4) >> sx), y + ((chunkY << 4) >> sy));
          if (fault) return;
        }
  }

  void transform_block(int plane, int baseX, int baseY, int x, int y) {
    int startX = baseX + 4 * x, startY = baseY + 4 * y;
    int sx = plane ? subsampling_x : 0, sy = plane ? subsampling_y : 0;
    int row = (startY << sy) >> 2, col = (startX << sx) >> 2;
    int sbMask = use_128x128_superblock ? 31 : 15;
    int sbRow = row & sbMask, sbCol = col & sbMask;
    int maxX = (MiCols * 4) >> sx, maxY = (MiRows * 4) >> sy;
    if (startX >= maxX || startY >= maxY) return;
    bool isCfl = plane > 0 && UVMode == UV_CFL_PRED;
    int mode = plane == 0 ? YMode : (isCfl ? DC_PRED : UVMode);
    predict_intra(plane, startX, startY, (plane == 0 ? AvailL : AvailLChroma) || x > 0,
                  (plane == 0 ? AvailU : AvailUChroma) || y > 0,
                  bd(plane, (sbRow >> sy) - 1, (sbCol >> sx) + 1),
                  bd(plane, (sbRow >> sy) + 1, (sbCol >> sx) - 1), mode);
    if (isCfl) predict_chroma_from_luma(plane, startX, startY);
    if (plane == 0) {
      MaxLumaW = startX + 4;
      MaxLumaH = startY + 4;
    }
    if (!skip) {
      int eob = coeffs(plane, startX, startY);
      if (eob > 0) reconstruct(plane, startX, startY);
    }
    bd(plane, sbRow >> sy, sbCol >> sx) = 1;
  }

  // --- coeffs at TX_4X4 (DCT_DCT, the default scan, q context 0) ---
  int coeffs(int plane, int startX, int startY) {
    int x4 = startX >> 2, y4 = startY >> 2;
    int ptype = plane > 0;
    int sx = plane ? subsampling_x : 0, sy = plane ? subsampling_y : 0;
    int maxX4 = MiCols >> sx, maxY4 = MiRows >> sy;
    for (int i = 0; i < 16; i++) Quant[i] = 0;
    std::memset(Near, 0, sizeof(Near));
    // all_zero's context
    int ctx;
    int bsize = plane ? subsampled_size(MiSize, sx, sy) : MiSize;
    if (plane == 0) {
      int top = x4 < maxX4 ? AboveLevel[0][x4] : 0, left = y4 < maxY4 ? LeftLevel[0][y4] : 0;
      if (kBw4[bsize] == 1 && kBh4[bsize] == 1) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = x4 < maxX4 ? (AboveLevel[plane][x4] | AboveDc[plane][x4]) : 0;
      int left = y4 < maxY4 ? (LeftLevel[plane][y4] | LeftDc[plane][y4]) : 0;
      ctx = 7 + (above != 0) + (left != 0);
      if (kBw4[bsize] * kBh4[bsize] > 1) ctx += 3;
    }
    int all_zero = sd.read(cdf.txbSkip[ctx], 2);
    int eob = 0, culLevel = 0, dcCategory = 0;
    if (!all_zero) {
      int eobPt = sd.read(cdf.eobPt16[ptype][0], 5) + 1;
      eob = eobPt < 2 ? eobPt : (1 << (eobPt - 2)) + 1;
      int eobShift = eobPt - 3;
      if (eobShift >= 0) {
        if (sd.read(cdf.eobExtra[ptype][eobPt - 3], 2)) eob += 1 << eobShift;
        for (int i = 1; i < std::max(0, eobPt - 2); i++) {
          eobShift = std::max(0, eobPt - 2) - 1 - i;
          if (sd.read_literal(1)) eob += 1 << eobShift;
        }
      }
      for (int c = eob - 1; c >= 0; c--) {
        int pos = kDefaultScan4x4[c];
        int level;
        if (c == eob - 1) {
          int cctx = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
          level = sd.read(cdf.baseEob[ptype][cctx], 3) + 1;
        } else {
          level = sd.read(cdf.base[ptype][coeff_base_ctx(pos)], 4);
        }
        if (level > 2) {
          int bctx = coeff_br_ctx(pos);
          for (int idx = 0; idx < 4; idx++) {
            int k = sd.read(cdf.br[ptype][bctx], 4);
            level += k;
            if (k < 3) break;
          }
        }
        Quant[pos] = level;
        Near[pos >> 2][pos & 3] = std::min(level, 3);
      }
      for (int c = 0; c < eob; c++) {
        int pos = kDefaultScan4x4[c];
        int sign = 0;
        if (Quant[pos] != 0) {
          if (c == 0) {
            int dcSign = 0;
            if (x4 < maxX4) dcSign += AboveDc[plane][x4] == 1 ? -1 : AboveDc[plane][x4] == 2 ? 1 : 0;
            if (y4 < maxY4) dcSign += LeftDc[plane][y4] == 1 ? -1 : LeftDc[plane][y4] == 2 ? 1 : 0;
            int sctx = dcSign < 0 ? 1 : dcSign > 0 ? 2 : 0;
            sign = sd.read(cdf.dcSign[ptype][sctx], 2);
          } else {
            sign = sd.read_literal(1);
          }
        }
        int64_t q = Quant[pos];
        if (q > 14) {
          int length = 0, bit;
          do {
            length++;
            bit = sd.read_literal(1);
            if (length > 32) { fault = true; return 0; }
          } while (!bit);
          int64_t x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | sd.read_literal(1);
          q = x + 14;
        }
        if (pos == 0 && q > 0) dcCategory = sign ? 1 : 2;
        q &= 0xFFFFF;
        culLevel += int(q);
        Quant[pos] = sign ? -int(q) : int(q);
      }
      culLevel = std::min(63, culLevel);
    }
    AboveLevel[plane][x4] = uint8_t(culLevel);
    AboveDc[plane][x4] = uint8_t(dcCategory);
    LeftLevel[plane][y4] = uint8_t(culLevel);
    LeftDc[plane][y4] = uint8_t(dcCategory);
    return eob;
  }

  int coeff_base_ctx(int pos) {  // Sig_Ref_Diff_Offset of TX_CLASS_2D
    int row = pos >> 2, col = pos & 3;
    if (row == 0 && col == 0) return 0;
    int mag = Near[row][col + 1] + Near[row + 1][col] + Near[row + 1][col + 1] +
              Near[row][col + 2] + Near[row + 2][col];
    return std::min((mag + 1) >> 1, 4) + kCoeffBaseCtxOffset4x4[row][col];
  }

  int coeff_br_ctx(int pos) {
    int row = pos >> 2, col = pos & 3;
    static const int off[3][2] = {{0, 1}, {1, 0}, {1, 1}};
    int mag = 0;
    for (int i = 0; i < 3; i++) {
      int rr = row + off[i][0], cc = col + off[i][1];
      if (rr < 4 && cc < 4) mag += std::min(Quant[rr * 4 + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
    return mag + 14;
  }

  // --- reconstruct under Lossless: the inverse Walsh-Hadamard transform ---
  static void inverse_wht(int32_t* T, int shift) {
    int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
    a += c;
    d -= b;
    int32_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    T[0] = a;
    T[1] = b;
    T[2] = c;
    T[3] = d;
  }

  void reconstruct(int plane, int x, int y) {
    int32_t R[4][4];
    for (int i = 0; i < 4; i++) {
      int32_t T[4];
      for (int j = 0; j < 4; j++) {
        int32_t q = Quant[i * 4 + j];
        int32_t dq = (std::abs(q) * 4) & 0xFFFFFF;  // dc_q(0) = ac_q(0) = 4 at 8 bits
        T[j] = q < 0 ? -dq : dq;
      }
      inverse_wht(T, 2);
      for (int j = 0; j < 4; j++) R[i][j] = T[j];
    }
    for (int j = 0; j < 4; j++) {
      int32_t T[4] = {R[0][j], R[1][j], R[2][j], R[3][j]};
      inverse_wht(T, 0);
      for (int i = 0; i < 4; i++) R[i][j] = T[i];
    }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        uint8_t& p = px(plane, y + i, x + j);
        p = uint8_t(std::min(255, std::max(0, int(p) + R[i][j])));
      }
  }

  // --- intra prediction of a 4x4 transform block ---
  int is_smooth(int row, int col, int plane) {
    int mode = plane == 0 ? mi(YModes, row, col) : mi(UVModes, row, col);
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
  }

  int get_filter_type(int plane) {
    int aboveSmooth = 0, leftSmooth = 0;
    if (plane == 0 ? AvailU : AvailUChroma) {
      int r = MiRow - 1, c = MiCol;
      if (plane > 0) {
        if (subsampling_x && !(MiCol & 1)) c++;
        if (subsampling_y && (MiRow & 1)) r--;
      }
      aboveSmooth = is_smooth(r, c, plane);
    }
    if (plane == 0 ? AvailL : AvailLChroma) {
      int r = MiRow, c = MiCol - 1;
      if (plane > 0) {
        if (subsampling_x && (MiCol & 1)) c--;
        if (subsampling_y && !(MiRow & 1)) r++;
      }
      leftSmooth = is_smooth(r, c, plane);
    }
    return aboveSmooth || leftSmooth;
  }

  static int edge_strength(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h, s = 0;
    if (filterType == 0) {
      if (blkWh <= 8) { if (d >= 56) s = 1; }
      else if (blkWh <= 12) { if (d >= 40) s = 1; }
      else if (blkWh <= 16) { if (d >= 40) s = 1; }
      else if (blkWh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (blkWh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (blkWh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (blkWh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (blkWh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }

  static void edge_filter(int* buf, int sz, int strength) {  // buf[-1 .. sz-2]
    if (!strength) return;
    int edge[40];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = std::min(sz - 1, std::max(0, i - 2 + j));
        s += kEdgeKernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }

  static int use_upsample(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filterType == 0 ? blkWh <= 16 : blkWh <= 8;
  }

  static void edge_upsample(int* buf, int numPx) {
    int dup[40];
    dup[0] = buf[-1];
    for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
    dup[numPx + 2] = buf[numPx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numPx; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = std::min(255, std::max(0, (s + 8) >> 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int haveLeft, int haveAbove, int haveAboveRt,
                     int haveBelowLft, int mode) {
    const int w = 4, h = 4;
    int sx = plane ? subsampling_x : 0, sy = plane ? subsampling_y : 0;
    int maxX = ((MiCols * 4) >> sx) - 1, maxY = ((MiRows * 4) >> sy) - 1;
    int aboveBuf[48], leftBuf[48];
    int* aboveRow = aboveBuf + 16;
    int* leftCol = leftBuf + 16;
    for (int i = 0; i < w + h; i++) {
      if (!haveAbove && haveLeft) aboveRow[i] = px(plane, y, x - 1);
      else if (!haveAbove) aboveRow[i] = 127;
      else aboveRow[i] = px(plane, y - 1, std::min(std::min(maxX, x + (haveAboveRt ? 2 * w : w) - 1), x + i));
      if (!haveLeft && haveAbove) leftCol[i] = px(plane, y - 1, x);
      else if (!haveLeft) leftCol[i] = 129;
      else leftCol[i] = px(plane, std::min(std::min(maxY, y + (haveBelowLft ? 2 * h : h) - 1), y + i), x - 1);
    }
    if (haveAbove && haveLeft) aboveRow[-1] = px(plane, y - 1, x - 1);
    else if (haveAbove) aboveRow[-1] = px(plane, y - 1, x);
    else if (haveLeft) aboveRow[-1] = px(plane, y, x - 1);
    else aboveRow[-1] = 128;
    leftCol[-1] = aboveRow[-1];
    int pred[4][4];
    if (plane == 0 && use_filter_intra) {
      for (int i2 = 0; i2 < 2; i2++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) p[i] = aboveRow[i - 1];
            else if (i == 0) p[i] = leftCol[(i2 << 1) - 1];
            else p[i] = pred[(i2 << 1) - 1][i - 1];
          } else {
            p[i] = leftCol[(i2 << 1) + i - 5];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += kFilterTaps[filter_intra_mode][i][j] * p[j];
          int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
          pred[(i2 << 1) + (i >> 2)][i & 3] = std::min(255, std::max(0, v));
        }
      }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      int pAngle = kModeToAngle[mode] + (plane == 0 ? AngleDeltaY : AngleDeltaUV) * 3;
      int upsampleAbove = 0, upsampleLeft = 0;
      if (enable_intra_edge_filter) {
        if (pAngle != 90 && pAngle != 180) {
          if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
            int s = leftCol[0] * 5 + aboveRow[-1] * 6 + aboveRow[0] * 5;
            aboveRow[-1] = leftCol[-1] = (s + 8) >> 4;
          }
          int filterType = get_filter_type(plane);
          if (haveAbove) {
            int strength = edge_strength(w, h, filterType, pAngle - 90);
            int numPx = std::min(w, maxX - x + 1) + (pAngle < 90 ? h : 0) + 1;
            edge_filter(aboveRow, numPx, strength);
          }
          if (haveLeft) {
            int strength = edge_strength(w, h, filterType, pAngle - 180);
            int numPx = std::min(h, maxY - y + 1) + (pAngle > 180 ? w : 0) + 1;
            edge_filter(leftCol, numPx, strength);
          }
        }
        int filterType = get_filter_type(plane);
        upsampleAbove = use_upsample(w, h, filterType, pAngle - 90);
        if (upsampleAbove) edge_upsample(aboveRow, w + (pAngle < 90 ? h : 0));
        upsampleLeft = use_upsample(w, h, filterType, pAngle - 180);
        if (upsampleLeft) edge_upsample(leftCol, h + (pAngle > 180 ? w : 0));
      }
      int dx = 0, dy = 0;
      if (pAngle < 90) dx = dr_intra_derivative(pAngle);
      else if (pAngle > 90 && pAngle < 180) dx = dr_intra_derivative(180 - pAngle);
      if (pAngle > 90 && pAngle < 180) dy = dr_intra_derivative(pAngle - 90);
      else if (pAngle > 180) dy = dr_intra_derivative(270 - pAngle);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (pAngle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - upsampleAbove)) + (j << upsampleAbove);
            int shift = ((idx << upsampleAbove) >> 1) & 0x1F;
            int maxBaseX = (w + h - 1) << upsampleAbove;
            if (base < maxBaseX)
              v = (aboveRow[base] * (32 - shift) + aboveRow[base + 1] * shift + 16) >> 5;
            else
              v = aboveRow[maxBaseX];
          } else if (pAngle > 90 && pAngle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - upsampleAbove);
            if (base >= -(1 << upsampleAbove)) {
              int shift = ((idx * (1 << upsampleAbove)) >> 1) & 0x1F;
              v = (aboveRow[base] * (32 - shift) + aboveRow[base + 1] * shift + 16) >> 5;
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - upsampleLeft);
              int shift = ((idx * (1 << upsampleLeft)) >> 1) & 0x1F;
              v = (leftCol[base] * (32 - shift) + leftCol[base + 1] * shift + 16) >> 5;
            }
          } else if (pAngle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - upsampleLeft)) + (i << upsampleLeft);
            int shift = ((idx << upsampleLeft) >> 1) & 0x1F;
            v = (leftCol[base] * (32 - shift) + leftCol[base + 1] * shift + 16) >> 5;
          } else if (pAngle == 90) {
            v = aboveRow[j];
          } else {
            v = leftCol[i];
          }
          pred[i][j] = v;
        }
    } else if (mode == SMOOTH_PRED) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int s = kSmWeights4[i] * aboveRow[j] + (256 - kSmWeights4[i]) * leftCol[h - 1] +
                  kSmWeights4[j] * leftCol[i] + (256 - kSmWeights4[j]) * aboveRow[w - 1];
          pred[i][j] = (s + 256) >> 9;
        }
    } else if (mode == SMOOTH_V_PRED) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = (kSmWeights4[i] * aboveRow[j] + (256 - kSmWeights4[i]) * leftCol[h - 1] + 128) >> 8;
    } else if (mode == SMOOTH_H_PRED) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = (kSmWeights4[j] * leftCol[i] + (256 - kSmWeights4[j]) * aboveRow[w - 1] + 128) >> 8;
    } else if (mode == DC_PRED) {
      int avg;
      if (haveLeft && haveAbove) {
        int sum = 0;
        for (int k = 0; k < 4; k++) sum += leftCol[k] + aboveRow[k];
        avg = (sum + 4) / 8;
      } else if (haveLeft) {
        int sum = 0;
        for (int k = 0; k < 4; k++) sum += leftCol[k];
        avg = (sum + 2) >> 2;
      } else if (haveAbove) {
        int sum = 0;
        for (int k = 0; k < 4; k++) sum += aboveRow[k];
        avg = (sum + 2) >> 2;
      } else {
        avg = 128;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH_PRED
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = aboveRow[j] + leftCol[i] - aboveRow[-1];
          int pLeft = std::abs(base - leftCol[i]), pTop = std::abs(base - aboveRow[j]);
          int pTopLeft = std::abs(base - aboveRow[-1]);
          if (pLeft <= pTop && pLeft <= pTopLeft) pred[i][j] = leftCol[i];
          else if (pTop <= pTopLeft) pred[i][j] = aboveRow[j];
          else pred[i][j] = aboveRow[-1];
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) px(plane, y + i, x + j) = uint8_t(pred[i][j]);
  }

  void predict_chroma_from_luma(int plane, int startX, int startY) {
    int sx = subsampling_x, sy = subsampling_y;
    int alpha = plane == 1 ? CflAlphaU : CflAlphaV;
    int L[4][4], sum = 0;
    for (int i = 0; i < 4; i++) {
      int lumaY = std::min((startY + i) << sy, MaxLumaH - (1 << sy));
      for (int j = 0; j < 4; j++) {
        int lumaX = std::min((startX + j) << sx, MaxLumaW - (1 << sx));
        int t = 0;
        for (int dy = 0; dy <= sy; dy++)
          for (int dx = 0; dx <= sx; dx++) t += px(0, lumaY + dy, lumaX + dx);
        L[i][j] = t << (3 - sx - sy);
        sum += L[i][j];
      }
    }
    int avg = (sum + 8) >> 4;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        int scaled = alpha * (L[i][j] - avg);
        scaled = scaled >= 0 ? (scaled + 32) >> 6 : -((-scaled + 32) >> 6);
        uint8_t& p = px(plane, startY + i, startX + j);
        p = uint8_t(std::min(255, std::max(0, int(p) + scaled)));
      }
  }

  // --- tile_group_obu ---
  int tile_group(const uint8_t* data, int64_t sz) {
    BitReader br(data, sz);
    int NumTiles = TileCols * TileRows;
    int tg_start = 0, tg_end = NumTiles - 1;
    if (NumTiles > 1 && br.f(1)) {
      int tileBits = TileColsLog2 + TileRowsLog2;
      tg_start = int(br.f(tileBits));
      tg_end = int(br.f(tileBits));
    }
    br.byte_alignment();
    if (br.over || tg_start != tilesDone || tg_end < tg_start || tg_end >= NumTiles) return kCorrupt;
    int64_t pos = br.pos >> 3;
    for (int t = tg_start; t <= tg_end; t++) {
      int64_t tileSize;
      if (t == tg_end) {
        tileSize = sz - pos;
      } else {
        if (pos + TileSizeBytes > sz) return kCorrupt;
        BitReader tb(data + pos, TileSizeBytes);
        tileSize = int64_t(tb.le(TileSizeBytes)) + 1;
        pos += TileSizeBytes;
      }
      if (tileSize <= 0 || pos + tileSize > sz) return kCorrupt;
      int tileRow = t / TileCols, tileCol = t % TileCols;
      MiRowStart = MiRowStarts[tileRow];
      MiRowEnd = MiRowStarts[tileRow + 1];
      MiColStart = MiColStarts[tileCol];
      MiColEnd = MiColStarts[tileCol + 1];
      default_cdfs(cdf);
      sd.init(data + pos, tileSize, disable_cdf_update);
      decode_tile();
      if (fault) return kCorrupt;
      tilePadding.push_back(sd.padding_ok());
      pos += tileSize;
      tilesDone++;
    }
    return kOk;
  }

  // --- the OBUs of a temporal unit, up to the end of the first frame ---
  int run(const uint8_t* data, int64_t size, bool decode) {
    int64_t pos = 0;
    while (pos < size) {
      BitReader br(data + pos, size - pos);
      br.f(1);  // forbidden bit
      int obu_type = int(br.f(4));
      int extension = int(br.f(1));
      int has_size = int(br.f(1));
      br.f(1);
      if (extension) {
        temporal_id = int(br.f(3));
        spatial_id = int(br.f(2));
        br.f(3);
      }
      int64_t obu_size = has_size ? int64_t(br.leb128()) : size - pos - 1 - extension;
      if (br.over) return kCorrupt;
      int64_t start = pos + (br.pos >> 3);
      if (obu_size < 0 || obu_size > size - start) return kCorrupt;
      const uint8_t* obu = data + start;
      int idc = operating_point_idc[0];  // operating point 0: drop the OBUs of other layers
      if (obu_type != 1 && obu_type != 2 && extension && idc &&
          !(((idc >> temporal_id) & 1) && ((idc >> (spatial_id + 8)) & 1))) {
        pos = start + obu_size;
        continue;
      }
      if (obu_type == 1) {  // OBU_SEQUENCE_HEADER
        if (!haveFrame) {
          BitReader sb(obu, obu_size);
          int r = sequence_header(sb);
          if (r) return r;
          if (BitDepth != 8) return kHighBitDepth;
        }
      } else if (obu_type == 3 || obu_type == 6) {  // OBU_FRAME_HEADER, OBU_FRAME
        if (haveFrame && obu_type == 3) {
          // a redundant copy of the header (or the next frame's): the first frame is whole
          if (tilesDone == TileCols * TileRows) break;
        } else {
          BitReader fb(obu, obu_size);
          int r = frame_header(fb);
          if (r) return r;
          if (!decode) return kOk;
          alloc_frame();
          if (obu_type == 6) {
            fb.byte_alignment();
            int64_t used = fb.pos >> 3;
            if (used > obu_size) return kCorrupt;
            r = tile_group(obu + used, obu_size - used);
            if (r) return r;
          }
        }
      } else if (obu_type == 4) {  // OBU_TILE_GROUP
        if (!haveFrame) return kCorrupt;
        int r = tile_group(obu, obu_size);
        if (r) return r;
      }
      // temporal delimiters, metadata, padding and tile lists are passed over
      pos = start + obu_size;
      if (haveFrame && tilesDone == TileCols * TileRows) break;
    }
    if (!haveFrame) return kCorrupt;
    if (decode && tilesDone != TileCols * TileRows) return kCorrupt;
    return kOk;
  }
};

// ---------------------------------------------------------------------------
// libyuv's 8-bit YUV -> RGB as libavif calls it (I444/I422/I420ToARGBMatrix
// with kFilterBilinear): chroma rows upsampled by ScaleRowUp2_Linear and
// ScaleRowUp2_Bilinear with their Any wrappers' edges, then YuvPixel.
// utils/avif.py's yuv_to_rgb_plain is its plain twin.
// ---------------------------------------------------------------------------
static void up2_linear(const uint8_t* s, int w, int* d) {
  d[0] = s[0];
  int k = ((w - 1) & ~1) / 2;
  for (int x = 0; x < k; x++) {
    d[1 + 2 * x] = (3 * s[x] + s[x + 1] + 2) >> 2;
    d[2 + 2 * x] = (s[x] + 3 * s[x + 1] + 2) >> 2;
  }
  d[w - 1] = s[(w - 1) / 2];
}

// the row of a chroma row pair nearer ``s`` (near) or ``t``
static void up2_bilinear(const uint8_t* s, const uint8_t* t, int w, bool near, int* d) {
  if (!near) std::swap(s, t);
  d[0] = (3 * s[0] + t[0] + 2) >> 2;
  int k = ((w - 1) & ~1) / 2;
  for (int x = 0; x < k; x++) {
    d[1 + 2 * x] = (9 * s[x] + 3 * s[x + 1] + 3 * t[x] + t[x + 1] + 8) >> 4;
    d[2 + 2 * x] = (3 * s[x] + 9 * s[x + 1] + t[x] + 3 * t[x + 1] + 8) >> 4;
  }
  int j = (w - 1) / 2;
  d[w - 1] = (3 * s[j] + t[j] + 2) >> 2;
}

// one output row's chroma at the luma's width
static void chroma_row(const uint8_t* c, int cw, int w, int h, int sx, int sy, int r, int* d) {
  if (!sx) {
    for (int x = 0; x < w; x++) d[x] = c[size_t(r) * cw + x];
  } else if (!sy) {
    up2_linear(c + size_t(r) * cw, w, d);
  } else if (r == 0 || (r == h - 1 && !(h & 1))) {
    up2_linear(c + size_t(r == 0 ? 0 : (h - 1) / 2) * cw, w, d);
  } else {
    int k = (r - 1) / 2;
    up2_bilinear(c + size_t(k) * cw, c + size_t(k + 1) * cw, w, (r - 1) % 2 == 0, d);
  }
}

}  // namespace

extern "C" {

// Planes (Y h x w, U and V the subsampled size) -> (h, w, 3) R, G, B with
// libyuv's YuvConstants k = YG, YB, UB, UG, VG, VR.
void yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t w, int32_t h,
                int32_t sx, int32_t sy, const int32_t* k, uint8_t* rgb) {
  int yg = k[0], yb = k[1], ub = k[2], ug = k[3], vg = k[4], vr = k[5];
  int cw = (w + sx) >> sx;
  std::vector<int> U(w), V(w);
  for (int r = 0; r < h; r++) {
    chroma_row(u, cw, w, h, sx, sy, r, U.data());
    chroma_row(v, cw, w, h, sx, sy, r, V.data());
    const uint8_t* yr = y + size_t(r) * w;
    uint8_t* out = rgb + size_t(r) * w * 3;
    for (int x = 0; x < w; x++) {
      int y1 = int((uint32_t(yr[x]) * 0x0101u * uint32_t(yg)) >> 16) + yb;
      int cu = U[x] - 128, cv = V[x] - 128;
      int c[3] = {y1 + cv * vr, y1 - cu * ug - cv * vg, y1 + cu * ub};
      for (int i = 0; i < 3; i++) out[3 * x + i] = uint8_t(std::min(255, std::max(0, c[i] >> 6)));
    }
  }
}


// The sequence and frame headers of the first frame: info[0..11] = frame
// width, height, mono_chrome, subsampling_x, subsampling_y,
// matrix_coefficients, color_range, tiles, use_128x128_superblock,
// reduced_still_picture_header, disable_cdf_update,
// uniform_tile_spacing_flag. 0, or a refusal or fault code (negative).
int av1_probe(const uint8_t* data, int64_t size, int32_t* info) {
  Decoder* d = new Decoder();
  int r = d->run(data, size, false);
  if (r == kOk) {
    int32_t v[12] = {d->FrameWidth, d->FrameHeight, d->mono_chrome, d->subsampling_x,
                     d->subsampling_y, d->matrix_coefficients, d->color_range,
                     d->TileCols * d->TileRows, d->use_128x128_superblock,
                     d->reduced_still_picture_header, d->disable_cdf_update,
                     d->uniform_tile_spacing_flag};
    std::memcpy(info, v, sizeof(v));
  }
  delete d;
  return r;
}

// Decode the first frame into ``y`` (height x width), ``u`` and ``v``
// (the subsampled planes, rounded up), cropped to the frame size.
// ``padding`` gets each tile's exit-process padding check (1 where the
// trailing bits are the specification's), at most ``max_tiles`` of them.
int av1_decode(const uint8_t* data, int64_t size, uint8_t* y, uint8_t* u, uint8_t* v,
               int32_t* padding, int32_t max_tiles) {
  Decoder* d = new Decoder();
  int r = d->run(data, size, true);
  if (r == kOk) {
    uint8_t* out[3] = {y, u, v};
    for (int p = 0; p < d->NumPlanes; p++) {
      int sx = p ? d->subsampling_x : 0, sy = p ? d->subsampling_y : 0;
      int w = (d->FrameWidth + sx) >> sx, h = (d->FrameHeight + sy) >> sy;
      for (int i = 0; i < h; i++) std::memcpy(out[p] + size_t(i) * w, &d->px(p, i, 0), w);
    }
    for (int t = 0; t < int(d->tilePadding.size()) && t < max_tiles; t++)
      padding[t] = d->tilePadding[t];
  }
  delete d;
  return r;
}

}  // extern "C"
